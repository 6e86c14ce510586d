"""In-process telemetry: the scheduler's metric series (port of
nomad_tpu/server/telemetry.py).

Series names are the reference's, so a dashboard that reads one reads
the other: ``nomad.plan.*`` (submit, evaluate, commit, queue depth,
batch size), ``nomad.worker.*`` (wait_for_index, invoke_scheduler_<type>,
batch widths), ``nomad.broker.*`` (eval wait, storm / shed deferrals,
quarantine), ``nomad.solver.*`` (dispatch times and counts by route,
resident-set hits and misses, dispatch bytes, the guard's outcomes),
``nomad.lpq.*`` (the LP tier), ``nomad.scheduler.*`` (placements made
by the kernels, by the host stack, and by the host stack under a tpu-*
algorithm) and the sanitizers' findings, ``nomad.lockcheck.*``,
``nomad.jitcheck.*``, ``nomad.statecheck.*`` and ``nomad.schedcheck.*``
(each module's docstring names its series).

A process-global registry of counters and sample series. A series keeps
a ring buffer of its most recent samples with running count, sum, min
and max; percentiles come from the buffer at snapshot time. Counters are
sharded per thread (no lock on ``incr``) and folded at read time; the
shards of dead threads fold into the base. Timer series (``sample_ms``,
``measure``) are milliseconds; gauge series (``sample``) carry their own
unit and render without the ``_ms`` suffixes.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List

_BUF = 2048

# The summary keys a timer series exposes (_Series.snapshot); gauge
# series carry the same keys with the _ms suffix stripped
# (_strip_ms_keys). Every rendering surface derives from these lists.
TIMER_SUMMARY_KEYS = ("count", "mean_ms", "min_ms", "max_ms",
                      "p50_ms", "p95_ms", "p99_ms")
GAUGE_SUMMARY_KEYS = tuple(k[:-3] if k.endswith("_ms") else k
                           for k in TIMER_SUMMARY_KEYS)


class _Series:
    __slots__ = ("count", "total", "vmin", "vmax", "buf", "pos")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = float("-inf")
        self.buf: List[float] = []
        self.pos = 0

    def add(self, v: float) -> None:
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v
        if len(self.buf) < _BUF:
            self.buf.append(v)
        else:
            self.buf[self.pos] = v
            self.pos = (self.pos + 1) % _BUF

    def snapshot(self) -> dict:
        out = {"count": self.count,
               "mean_ms": (self.total / self.count) if self.count else 0.0,
               "min_ms": self.vmin if self.count else 0.0,
               "max_ms": self.vmax if self.count else 0.0}
        if self.buf:
            s = sorted(self.buf)
            n = len(s)
            out["p50_ms"] = s[n // 2]
            out["p95_ms"] = s[min(n - 1, int(n * 0.95))]
            out["p99_ms"] = s[min(n - 1, int(n * 0.99))]
        return out


class _CounterShard:
    """One thread's private counter buffer. The owner thread is the only
    WRITER (no lock on the hot incr path); readers fold the shard into
    the aggregate without mutating it, so the worst a racing read can be
    is one increment stale. ``gen`` ties the shard to the registry
    generation so reset() invalidates every live thread's cached shard."""

    __slots__ = ("data", "gen", "thread")

    def __init__(self, gen: object, thread):
        self.data: Dict[str, int] = {}
        self.gen = gen
        self.thread = thread


class Telemetry:
    def __init__(self):
        self._lock = threading.Lock()
        self._series: Dict[str, _Series] = {}
        self._gauges: Dict[str, _Series] = {}
        # counter aggregate = _counters (the fold base) + every live
        # shard: counters are sharded per thread so the hot incr path
        # takes no lock, and folded at read time (snapshot, statsd flush)
        self._counters: Dict[str, int] = {}
        self._shards: List[_CounterShard] = []
        self._gen: object = object()
        self._local = threading.local()

    def sample_ms(self, name: str, ms: float) -> None:
        with self._lock:
            s = self._series.get(name)
            if s is None:
                s = self._series[name] = _Series()
            s.add(ms)

    def sample(self, name: str, value: float) -> None:
        """Gauge-style sample in the series' own unit (lane counts,
        bytes, depths, ...), apart from sample_ms so a count never
        reads as a latency."""
        with self._lock:
            s = self._gauges.get(name)
            if s is None:
                s = self._gauges[name] = _Series()
            s.add(value)

    def measure(self, name: str):
        """Context manager timing a block into `name` (milliseconds)."""
        return _Timer(self, name)

    def incr(self, name: str, n: int = 1) -> None:
        """Lock-free hot path: bump this thread's private shard. The
        aggregate (base + shards) is folded at read time."""
        shard = getattr(self._local, "shard", None)
        if shard is None or shard.gen is not self._gen:
            shard = self._register_shard()
        data = shard.data
        data[name] = data.get(name, 0) + n

    def _register_shard(self) -> _CounterShard:
        cur = threading.current_thread()
        with self._lock:
            shard = _CounterShard(self._gen, cur)
            self._shards.append(shard)
            # opportunistic hygiene: fold shards of dead threads into
            # the base so ephemeral per-eval threads don't accumulate
            if len(self._shards) > 128:
                self._fold_dead_locked()
        self._local.shard = shard
        return shard

    def _fold_dead_locked(self) -> None:
        """Fold dead threads' shards into the base (their owners can no
        longer write, so the fold is exact) and drop them."""
        live: List[_CounterShard] = []
        for shard in self._shards:
            if shard.thread.is_alive():
                live.append(shard)
                continue
            for k, v in shard.data.items():
                self._counters[k] = self._counters.get(k, 0) + v
        self._shards = live

    def _counters_folded_locked(self) -> Dict[str, int]:
        self._fold_dead_locked()
        out = dict(self._counters)
        for shard in self._shards:
            # live shard: read-only fold (dict iteration is safe under
            # the GIL; a concurrent incr is at most one count stale)
            for k, v in list(shard.data.items()):
                out[k] = out.get(k, 0) + v
        return out

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "samples": {k: v.snapshot()
                            for k, v in self._series.items()},
                # unit-free gauge series: same percentile summary, but
                # the _ms key suffixes are a lie for these -- consumers
                # present them unitless (see _strip_ms_keys)
                "gauges": {k: _strip_ms_keys(v.snapshot())
                           for k, v in self._gauges.items()},
                "counters": self._counters_folded_locked(),
            }

    def reset(self) -> None:
        with self._lock:
            self._series.clear()
            self._gauges.clear()
            self._counters.clear()
            self._shards = []
            # invalidate every live thread's cached shard: their next
            # incr re-registers against the new generation
            self._gen = object()


def _strip_ms_keys(snap: dict) -> dict:
    return {(k[:-3] if k.endswith("_ms") else k): v
            for k, v in snap.items()}


class _Timer:
    __slots__ = ("t", "name", "t0")

    def __init__(self, t: Telemetry, name: str):
        self.t = t
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.t.sample_ms(self.name, (time.perf_counter() - self.t0) * 1e3)
        return False


class StatsdSink:
    """Periodic UDP statsd flush of the registry. Counters emit deltas
    as ``<name>:<delta>|c``; timer series emit their window mean as
    ``<name>:<mean_ms>|ms``, gauge series as ``<name>:<mean>|g``."""

    def __init__(self, address: str, registry: "Telemetry",
                 interval_s: float = 1.0):
        import socket
        host, _, port = address.rpartition(":")
        self._addr = (host or "127.0.0.1", int(port))
        self._registry = registry
        self._interval = interval_s
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._last_counts: dict = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="statsd-sink")

    def start(self) -> None:
        self._thread.start()

    def shutdown(self) -> None:
        self._stop.set()
        self.flush()

    def _loop(self) -> None:
        while not self._stop.wait(self._interval):
            self.flush()

    def flush(self) -> None:
        snap = self._registry.snapshot()
        lines = []
        for name, total in snap.get("counters", {}).items():
            delta = total - self._last_counts.get(name, 0)
            # a counter can only move forward; total < last means the
            # registry was reset (metrics.reset()) or restarted -- a
            # negative `|c` line is invalid statsd and real daemons
            # either drop it or corrupt the gauge, so resync the
            # baseline and emit nothing until the counter climbs again
            if delta > 0:
                lines.append(f"{name}:{delta}|c")
            self._last_counts[name] = total
        for name, s in snap.get("samples", {}).items():
            if s.get("count"):
                lines.append(f"{name}:{s.get('mean_ms', 0.0):.3f}|ms")
        for name, s in snap.get("gauges", {}).items():
            if s.get("count"):
                lines.append(f"{name}:{s.get('mean', 0.0):.3f}|g")
        if not lines:
            return
        try:
            self._sock.sendto("\n".join(lines).encode(), self._addr)
        except OSError:
            pass                  # sink loss must never hurt the server


# The process-global registry.
metrics = Telemetry()
