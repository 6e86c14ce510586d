"""The port's eval-scoped tracer (server/tracing.py) held against the JAX
package's: the scenarios of tests/test_tracing.py (its HTTP surface and
waterfall renderer are left out with the port's HTTP and CLI), each run
through both tracers with the same script and compared, then the spans
both Servers record for the same world, the pipelined barrier's
cross-thread handoff, and the kill switch's bit-for-bit parity.

The knobs are set under both prefixes (NOMAD_TPU_TRACE_* for the
reference, NOMAD_TPU_TORCH_TRACE_* for the port). Each test resets both
packages' globals; every wait and join has a deadline."""
import random
import threading
import time

import pytest

from nomad_tpu.server import tracing as ref_tracing
from nomad_tpu_torch.server import tracing as port_tracing
from nomad_tpu_torch.solver import batch

from test_torch_server import (  # noqa: F401
    fresh_state, run_servers, server_digest)
from test_torch_scheduler import tier_world
from test_torch_telemetry import reset_globals

PKGS = [pytest.param(ref_tracing, id="ref"),
        pytest.param(port_tracing, id="port")]


def setenv(monkeypatch, name, value):
    """A tracer knob under both packages' prefixes."""
    monkeypatch.setenv("NOMAD_TPU_" + name, value)
    monkeypatch.setenv("NOMAD_TPU_TORCH_" + name, value)


@pytest.fixture(autouse=True)
def clean_tracers(monkeypatch):
    setenv(monkeypatch, "TRACE_SAMPLE", "1.0")
    reset_globals()
    yield
    reset_globals()


def both(script):
    """``script(tracer)`` on each package's tracer: (ref, port) results."""
    return tuple(script(m.tracer) for m in (ref_tracing, port_tracing))


def _stats(tr):
    st = tr.stats()
    st.pop("enabled")
    return st


@pytest.mark.parametrize("mod", PKGS)
def test_begin_span_end_roundtrip(mod):
    tracer = mod.tracer
    ctx = tracer.begin("ev-1", job="j1", lane="service")
    with tracer.activate(ctx):
        with tracer.span("stage.a", step=1):
            # nomadlint: waive=no-sleep-sync -- simulated work: the measured
            # duration is the subject
            time.sleep(0.01)
        with tracer.span("stage.b", ctx=ctx):
            pass
    tracer.end("ev-1")
    tr = tracer.get("ev-1")
    assert tr["eval_id"] == "ev-1" and tr["tags"]["job"] == "j1"
    assert [s["name"] for s in tr["spans"]] == ["stage.a", "stage.b"]
    assert tr["spans"][0]["dur_ms"] >= 5.0
    assert tr["spans"][0]["tags"] == {"step": 1}


def test_tail_retention_is_the_references(monkeypatch):
    """Healthy traces sampled out, degraded and failed ones always kept,
    slow ones always kept: the same verdicts in both."""
    setenv(monkeypatch, "TRACE_SAMPLE", "0")
    setenv(monkeypatch, "TRACE_SLOW_MS", "5")

    def script(tracer):
        for i in range(20):
            tracer.begin(f"ok-{i}")
            tracer.end(f"ok-{i}")
        ctx = tracer.begin("bad-1")
        tracer.mark_degraded("host_fallback", ctx=ctx)
        tracer.end("bad-1")
        tracer.begin("err-1")
        tracer.end("err-1", status="nacked", error="Boom: x")
        ctx = tracer.begin("slow-1")
        tracer.record("stage", time.time() - 1.0, 1000.0, ctx=ctx)
        tracer.end("slow-1")
        bad = tracer.get("bad-1")
        return (_stats(tracer),
                bad["degraded_reason"],
                [s["name"] for s in bad["spans"]],
                tracer.get("err-1")["error"],
                tracer.get("slow-1") is not None,
                sorted(t["eval_id"] for t in tracer.list_traces(limit=0)))

    want, got = both(script)
    assert got == want
    assert got[0]["retained"] == 3 and got[0]["dropped"] == 20
    assert got[1] == "host_fallback" and "degraded" in got[2]


def test_memory_caps_apply_the_same_way(monkeypatch):
    setenv(monkeypatch, "TRACE_CAP", "8")
    setenv(monkeypatch, "TRACE_MAX_SPANS", "4")

    def script(tracer):
        for i in range(50):
            ctx = tracer.begin(f"cap-{i}")
            for k in range(10):          # past MAX_SPANS: truncated
                tracer.event(f"s{k}", ctx=ctx)
            tracer.mark_degraded("host_fallback", ctx=ctx)
            tracer.end(f"cap-{i}")
        tr = tracer.get("cap-49")
        return (_stats(tracer), len(tr["spans"]), tr["truncated_spans"],
                [t["eval_id"] for t in tracer.list_traces(limit=0)])

    want, got = both(script)
    assert got == want
    assert got[0]["retained"] <= 8 and got[1] == 4 and got[2] > 0


def test_byte_cap_evicts_oldest_the_same_way(monkeypatch):
    setenv(monkeypatch, "TRACE_MB", "0.01")

    def script(tracer):
        for i in range(64):
            ctx = tracer.begin(f"byte-{i}")
            for _ in range(8):
                tracer.event("stage.with.a.longish.name", ctx=ctx,
                             detail="x" * 64)
            tracer.mark_degraded("host_fallback", ctx=ctx)
            tracer.end(f"byte-{i}")
        return (_stats(tracer), tracer.get("byte-63") is not None,
                [t["eval_id"] for t in tracer.list_traces(limit=0)])

    want, got = both(script)
    assert got == want
    assert got[0]["retained_bytes"] <= 0.01 * 1024 * 1024
    assert got[0]["retained"] < 64 and got[1]


@pytest.mark.parametrize("mod", PKGS)
def test_kill_switch_no_ops(mod, monkeypatch):
    setenv(monkeypatch, "TRACE", "0")
    tracer = mod.tracer
    assert not mod.trace_enabled()
    assert tracer.begin("off-1") is None
    with tracer.span("x") as sp:
        sp.tag(a=1)
    tracer.mark_degraded("host_fallback")
    tracer.broadcast_event("breaker.trip", degraded_reason="breaker_open")
    tracer.end("off-1")
    st = tracer.stats()
    assert st["active"] == 0 and st["retained"] == 0


@pytest.mark.parametrize("mod", PKGS)
def test_group_ctx_fans_out_to_every_member(mod):
    tracer = mod.tracer
    a = tracer.begin("ga")
    b = tracer.begin("gb")
    g = tracer.group([a, b, None, a])
    assert isinstance(g, mod.TraceCtx) and len(g.traces) == 2
    with tracer.span("fused", ctx=g, generation=3):
        pass
    tracer.broadcast_event("breaker.trip", degraded_reason="breaker_open")
    tracer.end("ga")
    tracer.end("gb")
    for tid in ("ga", "gb"):
        tr = tracer.get(tid)
        assert [s["name"] for s in tr["spans"]] == ["fused", "degraded"]
        assert tr["spans"][0]["tags"]["generation"] == 3
        assert tr["degraded_reason"] == "breaker_open"


@pytest.mark.parametrize("mod", PKGS)
def test_explicit_handoff_across_threads(mod):
    tracer = mod.tracer
    ctx = tracer.begin("xt-1")
    done = threading.Event()

    def pipeline_thread():
        with tracer.activate(ctx):
            with tracer.span("solver.fuse_dispatch", generation=1):
                pass
        done.set()

    threading.Thread(target=pipeline_thread, daemon=True,
                     name="handoff").start()
    assert done.wait(5.0)
    tracer.end("xt-1")
    spans = tracer.get("xt-1")["spans"]
    assert [s["name"] for s in spans] == ["solver.fuse_dispatch"]
    assert spans[0]["thread"] == "handoff"


def test_abandoned_active_traces_bounded_alike(monkeypatch):
    setenv(monkeypatch, "TRACE_CAP", "4")

    def script(tracer):
        for i in range(100):               # never ended
            tracer.begin(f"leak-{i}")
        return _stats(tracer)

    want, got = both(script)
    assert got == want and got["active"] <= 16


def test_sampling_keeps_the_same_ids_without_rng(monkeypatch):
    """The keep fraction is a hash of the eval id: both packages keep the
    same traces, and no RNG state moves."""
    setenv(monkeypatch, "TRACE_SAMPLE", "0.5")
    ids = [f"det-{i}" for i in range(64)] + [
        f"{i:08x}-0000-4000-8000-{i:012x}" for i in range(64)]
    for i in ids:
        assert port_tracing._keep_fraction(i) == \
            ref_tracing._keep_fraction(i)
    random.seed(1234)
    before = random.getstate()

    def script(tracer):
        for i in ids:
            tracer.begin(i)
            tracer.end(i)
        return {t["eval_id"] for t in tracer.list_traces(limit=0)}

    want, got = both(script)
    assert random.getstate() == before
    assert got == want and 0 < len(got) < len(ids)


def test_chrome_trace_export_matches():
    def script(tracer):
        ctx = tracer.begin("ch-1")
        with tracer.span("stage.a", ctx=ctx):
            pass
        tracer.mark_degraded("watchdog_timeout", ctx=ctx)
        tracer.end("ch-1")
        doc = tracer.chrome_trace()
        return doc, [(e["ph"], e["name"], e.get("tid"))
                     for e in doc["traceEvents"]]

    (_, want), (doc, got) = both(script)
    assert got == want
    metas = [e for e in doc["traceEvents"] if e["ph"] == "M"]
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert "degraded:watchdog_timeout" in metas[0]["args"]["name"]
    assert xs and all(e["ts"] > 0 and e["dur"] >= 0 for e in xs)
    assert doc["displayTimeUnit"] == "ms"


# --------------------------------------------------------------------------
# both Servers on one world

SPAN_WORLDS = [(2, 40, 30, 1), (1, 5, 3, 0), (3, 40, 30, 100),
               (5, 24, 12, 42)]


def span_names(tracer, eval_id):
    tr = tracer.get(eval_id)
    assert tr is not None, eval_id
    return {s["name"] for s in tr["spans"]}, tr


@pytest.mark.parametrize("tier,n,count,seed", SPAN_WORLDS)
def test_servers_record_the_same_span_names_per_eval(tier, n, count, seed):
    """The same world through both Servers: each eval's trace holds the
    same set of span names (broker.wait through plan.commit, the
    barrier's fused dispatch and the resident set's events), recorded
    from more than one thread, and ends complete."""
    store, ev, _ = tier_world(tier, n, count, seed, "tpu-binpack")
    run_servers(store, [ev])
    want, _ = span_names(ref_tracing.tracer, ev.id)
    got, tr = span_names(port_tracing.tracer, ev.id)
    assert got == want
    for name in ("broker.wait", "worker.wait_for_index", "worker.invoke",
                 "solver.pack", "solver.barrier", "solver.fuse_dispatch",
                 "solver.materialize", "plan.submit", "plan.evaluate",
                 "plan.commit"):
        assert name in got, (name, sorted(got))
    assert len({s["thread"] for s in tr["spans"]}) > 1
    assert tr["status"] == "complete"
    fuse = [s for s in tr["spans"] if s["name"] == "solver.fuse_dispatch"]
    assert fuse[0]["tags"]["lanes"] == 1


def test_trace_off_scheduling_parity(monkeypatch):
    """NOMAD_TPU_TORCH_TRACE=0: the port's Server commits the same
    placements, scores and evals as with tracing on, and records
    nothing."""
    store, ev, _ = tier_world(3, 24, 8, 7, "tpu-binpack")
    _, on = run_servers(store, [ev])
    want = server_digest(on)
    reset_globals()
    monkeypatch.setenv("NOMAD_TPU_TORCH_TRACE", "0")
    store, ev, _ = tier_world(3, 24, 8, 7, "tpu-binpack")
    _, off = run_servers(store, [ev])
    assert server_digest(off) == want
    st = port_tracing.tracer.stats()
    assert st["active"] == 0 and st["retained"] == 0


def test_pipelined_barrier_spans_reach_every_eval_trace(monkeypatch):
    """Depth 3: the fused dispatch runs on a pipeline thread, and its
    span still lands in both evals' traces through the ctx carried in the
    barrier cells."""
    monkeypatch.setenv("NOMAD_TPU_TORCH_BATCH_FIXPOINT", "0")
    tracer = port_tracing.tracer

    class Lane:
        def fuse_key(self):
            return ("t",)

    monkeypatch.setattr(batch, "fuse_and_solve",
                        lambda lanes, **kw: [("ok",) for _ in lanes])
    barrier = batch.SolveBarrier(participants=2, depth=3, device="cpu")
    errs = []

    def eval_thread(k):
        ctx = tracer.begin(f"pipe-{k}")
        try:
            with tracer.activate(ctx):
                barrier.solve(Lane())
        except Exception as e:  # noqa: BLE001
            errs.append(e)
        finally:
            tracer.end(f"pipe-{k}")

    threads = [threading.Thread(target=eval_thread, args=(k,))
               for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(20)
        assert not t.is_alive()
    assert not errs, errs
    for k in range(2):
        names, tr = span_names(tracer, f"pipe-{k}")
        assert {"solver.fuse_dispatch", "solver.barrier",
                "solver.order_wait"} <= names, (k, names)
        fuse = next(s for s in tr["spans"]
                    if s["name"] == "solver.fuse_dispatch")
        assert fuse["thread"].startswith("solver-dispatch"), fuse
        assert fuse["tags"]["lanes"] == 2 and fuse["tags"]["depth"] == 3
