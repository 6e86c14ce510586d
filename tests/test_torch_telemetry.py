"""The port's metrics registry (server/telemetry.py) held against the JAX
package's: the scenarios of tests/test_telemetry.py (its agent-config and
Prometheus cases are HTTP or agent surfaces the port leaves out), each
run through both registries with the same script, and the scheduler's
series of one world through both Servers.

Snapshots are compared whole where the script fixes every value, and
without the time fields where a block is timed. Each test resets both
packages' globals, and every wait has a deadline."""
import socket
import threading
import time

import pytest

from nomad_tpu.server import telemetry as ref_tel
from nomad_tpu.server.quality import observatory as ref_obs
from nomad_tpu.server.tracing import tracer as ref_tracer
from nomad_tpu.solver import batch as ref_batch
from nomad_tpu.solver import constcache as ref_constcache
from nomad_tpu.solver import xferobs as ref_xferobs

from nomad_tpu_torch.server import telemetry as port_tel
from nomad_tpu_torch.server.quality import observatory as port_obs
from nomad_tpu_torch.server.tracing import tracer as port_tracer
from nomad_tpu_torch.solver import batch as port_batch
from nomad_tpu_torch.solver import resident as port_resident
from nomad_tpu_torch.solver import xferobs as port_xferobs

from test_torch_native import ensure_reference_native
from test_torch_server import (  # noqa: F401
    enqueue_both, fresh_state, run_servers, server_pair, settle_both)
from test_torch_scheduler import parity_world, tier_world

PKGS = [pytest.param(ref_tel, id="ref"), pytest.param(port_tel, id="port")]

# counters compared only for presence: the wall-time ones (a dispatch
# over 1 s, a trace kept for being slow). The native control plane's
# (nomad.native.*) and the pack caches' (whose misses the reference's
# native snapshot path changed) are compared with the reference's
# library loaded.
NOT_DETERMINISTIC = ("nomad.solver.dispatch_slow", "nomad.trace.")


def reset_globals():
    """Both packages' registries, tracers, ledgers, observatories,
    resident sets and stack arenas (a chain slot left by an earlier test
    would read a new store's journal from an index it never had; a
    pooled arena entry turns an alloc into a reuse)."""
    for c in (ref_constcache, port_resident):
        c._reset_for_tests()
    for b in (ref_batch, port_batch):
        b.arena_clear("test")
    for m in (ref_tel.metrics, port_tel.metrics):
        m.reset()
    for t in (ref_tracer, port_tracer):
        t._reset_for_tests()
    for x in (ref_xferobs, port_xferobs):
        x._reset_for_tests()
    for o in (ref_obs, port_obs):
        o._reset_for_tests()


@pytest.fixture(autouse=True)
def fresh_telemetry():
    ensure_reference_native()
    reset_globals()
    yield
    reset_globals()


def _script(t):
    for v in [1.0, 2.0, 3.0, 4.0, 100.0]:
        t.sample_ms("x", v)
    for v in [2.0, 4.0, 8.0]:
        t.sample("nomad.test.lanes", v)
    t.incr("c")
    t.incr("c", 2)
    return t.snapshot()


def test_same_script_gives_equal_snapshots():
    want = _script(ref_tel.Telemetry())
    got = _script(port_tel.Telemetry())
    assert got == want
    assert port_tel.TIMER_SUMMARY_KEYS == ref_tel.TIMER_SUMMARY_KEYS
    assert port_tel.GAUGE_SUMMARY_KEYS == ref_tel.GAUGE_SUMMARY_KEYS


@pytest.mark.parametrize("tel", PKGS)
def test_series_stats(tel):
    t = tel.Telemetry()
    snap = _script(t)
    s = snap["samples"]["x"]
    assert (s["count"], s["min_ms"], s["max_ms"], s["p50_ms"]) == (
        5, 1.0, 100.0, 3.0)
    assert snap["counters"]["c"] == 3
    t.reset()
    assert t.snapshot() == {"samples": {}, "gauges": {}, "counters": {}}


@pytest.mark.parametrize("tel", PKGS)
def test_gauge_series_are_unit_free(tel):
    t = tel.Telemetry()
    for v in [2.0, 4.0, 8.0]:
        t.sample("nomad.test.lanes", v)
    g = t.snapshot()["gauges"]["nomad.test.lanes"]
    assert g["count"] == 3 and g["min"] == 2.0 and g["max"] == 8.0
    assert not any(k.endswith("_ms") for k in g), sorted(g)
    assert "nomad.test.lanes" not in t.snapshot()["samples"]


def test_series_ring_buffer_wraparound():
    """Far more than the window: count, total, min and max cover every
    sample; the percentiles the most recent window; equal in both."""
    n = port_tel._BUF * 2 + 500
    assert port_tel._BUF == ref_tel._BUF
    snaps = []
    for tel in (ref_tel, port_tel):
        t = tel.Telemetry()
        for i in range(n):
            t.sample_ms("w", float(i))
        snaps.append(t.snapshot()["samples"]["w"])
    s = snaps[1]
    assert s == snaps[0]
    assert s["count"] == n and s["min_ms"] == 0.0
    assert s["max_ms"] == float(n - 1)
    window = sorted(range(n - port_tel._BUF, n))
    m = len(window)
    assert s["p50_ms"] == float(window[m // 2])
    assert s["p99_ms"] == float(window[min(m - 1, int(m * 0.99))])


@pytest.mark.parametrize("tel", PKGS)
def test_measure_context_manager(tel):
    t = tel.Telemetry()
    with t.measure("block"):
        # nomadlint: waive=no-sleep-sync -- simulated work: the measured
        # duration is the subject
        time.sleep(0.01)
    s = t.snapshot()["samples"]["block"]
    assert s["count"] == 1 and s["mean_ms"] >= 5.0
    assert sorted(s) == sorted(port_tel.TIMER_SUMMARY_KEYS)


def _sharded_run(tel):
    t = tel.Telemetry()
    lock = threading.Lock()
    plain = {}

    def ref_incr(name, n=1):
        with lock:
            plain[name] = plain.get(name, 0) + n

    def worker():
        for i in range(3000):
            name = f"nomad.test.c{i % 7}"
            t.incr(name)
            ref_incr(name)
            if i % 17 == 0:
                t.incr("nomad.test.bulk", 3)
                ref_incr("nomad.test.bulk", 3)

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for th in threads:
        th.start()
    for _ in range(20):
        t.snapshot()          # reads interleaved with live writers
    for th in threads:
        th.join(timeout=60)
        assert not th.is_alive()
    return t.snapshot()["counters"], plain


def test_sharded_counters_match_a_locked_count_in_both():
    got, plain = _sharded_run(port_tel)
    assert got == plain
    want, _ = _sharded_run(ref_tel)
    assert got == want


@pytest.mark.parametrize("tel", PKGS)
def test_sharded_counters_fold_dead_threads(tel):
    t = tel.Telemetry()

    def one_shot():
        t.incr("nomad.test.dead", 2)

    for _ in range(300):      # more than the 128-shard hygiene bound
        th = threading.Thread(target=one_shot)
        th.start()
        th.join(timeout=10)
    assert t.snapshot()["counters"]["nomad.test.dead"] == 600
    with t._lock:
        assert len(t._shards) < 300


@pytest.mark.parametrize("tel", PKGS)
def test_sharded_counters_reset_invalidates_live_shards(tel):
    t = tel.Telemetry()
    t.incr("nomad.test.r", 5)
    t.reset()
    assert t.snapshot()["counters"] == {}
    t.incr("nomad.test.r", 7)
    assert t.snapshot()["counters"]["nomad.test.r"] == 7


def _statsd_lines(tel):
    recv = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    recv.bind(("127.0.0.1", 0))
    recv.settimeout(3.0)
    port = recv.getsockname()[1]
    reg = tel.Telemetry()
    sink = tel.StatsdSink(f"127.0.0.1:{port}", reg, interval_s=60.0)
    out = []
    try:
        reg.incr("nomad.test.counter", 3)
        reg.sample_ms("nomad.test.latency", 12.5)
        reg.sample("nomad.test.depth", 4.0)
        sink.flush()
        out.append(recv.recv(65536).decode())
        reg.incr("nomad.test.counter", 2)      # only the new delta emits
        sink.flush()
        out.append(recv.recv(65536).decode())
        reg.reset()                  # a regression: the sink resyncs
        reg.incr("nomad.test.counter", 2)
        sink.flush()
        reg.incr("nomad.test.counter", 1)
        sink.flush()
        out.append(recv.recv(65536).decode())
    finally:
        sink.shutdown()
        recv.close()
    return out


def test_statsd_sink_emits_the_same_deltas():
    got = _statsd_lines(port_tel)
    assert "nomad.test.counter:3|c" in got[0]
    assert "nomad.test.latency:12.500|ms" in got[0]
    assert "nomad.test.depth:4.000|g" in got[0]
    assert "nomad.test.counter:2|c" in got[1]
    assert "-" not in got[2] and "nomad.test.counter:1|c" in got[2]
    assert got == _statsd_lines(ref_tel)


def native_counters(tel):
    return {k: v for k, v in tel.metrics.snapshot()["counters"].items()
            if k.startswith("nomad.native.")}


def deterministic(counters):
    return {k: v for k, v in counters.items()
            if not k.startswith(NOT_DETERMINISTIC)}


SERIES_WORLDS = [("tier", (2, 40, 30, 1)), ("tier", (1, 5, 3, 0)),
                 ("tier", (3, 40, 30, 100)), ("parity", "basic_service"),
                 ("parity", "with_spread_block")]


def _world(kind, arg):
    if kind == "tier":
        store, ev, _ = tier_world(*arg, "tpu-binpack")
        return store, ev
    from test_torch_scheduler import PARITY_WORLDS
    return parity_world(arg, list(PARITY_WORLDS[arg][2])[0],
                        "tpu-binpack")


@pytest.mark.parametrize("kind,arg", SERIES_WORLDS,
                         ids=[f"{k}-{a}" for k, a in SERIES_WORLDS])
def test_scheduler_series_emitted_end_to_end(kind, arg):
    """One world through both Servers: the reference's scheduler series
    are emitted by the port (plan.evaluate, plan.submit, plan.commit,
    worker.wait_for_index, invoke_scheduler_<type>, broker.eval_wait,
    the queue-depth and batch gauges), and every deterministic counter
    -- placements by route, dispatches by route, resident-set hits and
    misses, dispatch bytes, the guard's outcomes, the ledger's
    dispatches -- has the reference's value."""
    store, ev = _world(kind, arg)
    with server_pair(store) as (ref, port, memo):
        # the native control plane's counters from here on, each store
        # holding a snapshot to advance from: the carry took the
        # reference's, and the port's carried store takes one here
        port.state.snapshot()
        native_at_start = [native_counters(t) for t in (ref_tel, port_tel)]
        enqueue_both(ref, port, [ev], memo)
        settle_both(ref, port, [ev.id])
    want = ref_tel.metrics.snapshot()
    got = port_tel.metrics.snapshot()
    for snap, start in zip((want, got), native_at_start):
        for k, v in start.items():
            snap["counters"][k] -= v
    assert sorted(got["samples"]) == sorted(want["samples"])
    assert sorted(got["gauges"]) == sorted(want["gauges"])
    for name in ("nomad.plan.evaluate", "nomad.plan.submit",
                 "nomad.worker.wait_for_index", "nomad.broker.eval_wait"):
        assert got["samples"][name]["count"] >= 1
        assert (got["samples"][name]["count"]
                == want["samples"][name]["count"]), name
    assert got["gauges"]["nomad.plan.queue_depth"]["count"] >= 1
    assert deterministic(got["counters"]) == deterministic(want["counters"])
    assert got["counters"]["nomad.scheduler.placements_tpu"] >= 1
    assert got["counters"]["nomad.native.materialize_hits"] >= 1
    assert got["counters"]["nomad.native.snapshot_hits"] >= 1
