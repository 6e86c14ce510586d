"""The port's transfer ledger (solver/xferobs.py) held against the JAX
package's: byte parity of the tagged decomposition against
``nomad.solver.dispatch_bytes_total`` on every transport the port ships
through (the wave, dense, windowed and dense preemption, LP, system and
mesh routes, the mesh on 8 cpu cells), the per-group split compared with
the reference's on the same lanes, the kill switch as a bitwise no-op,
the transfer model, the residency map against ``resident.stats()``, the
fuse_dispatch span's tags, the counter tracks and the bench fields.

Where the port's split differs from the reference's it is by design and
named here: the port counts the system fit's one upload (``system``) and
the one-card LP's inputs (``lpq``), which the reference ships as jit
arguments outside the ledger. Each test resets both packages' globals."""
import copy
import time

import numpy as np
import pytest

from nomad_tpu import mock
from nomad_tpu.server.telemetry import metrics as ref_metrics
from nomad_tpu.solver import batch as ref_batch
from nomad_tpu.solver import constcache
from nomad_tpu.solver import xferobs as ref_xferobs

from nomad_tpu_torch.carry import lane_from_reference
from nomad_tpu_torch.server.quality import _STAGE_OF
from nomad_tpu_torch.server.telemetry import metrics
from nomad_tpu_torch.server.tracing import tracer
from nomad_tpu_torch.solver import batch, resident, xferobs

from test_torch_mesh import CELLS, _needs_8_devices, _sched_world
from test_torch_server import (  # noqa: F401
    fresh_state, lpq_world, run_servers, server_digest)
from test_torch_scheduler import system_world, tier_world
from test_torch_telemetry import reset_globals


@pytest.fixture(autouse=True)
def clean_layers(monkeypatch):
    monkeypatch.setenv("NOMAD_TPU_TORCH_TRACE_SAMPLE", "1")
    reset_globals()
    ref_batch.arena_clear("test")
    batch.arena_clear("test")
    yield
    reset_globals()


def counter_bytes(m=metrics):
    return m.snapshot()["counters"].get("nomad.solver.dispatch_bytes_total",
                                        0)


def assert_parity(x=xferobs, m=metrics):
    st = x.state()
    assert st["parity_bytes"] == 0 and x.parity() == 0
    assert st["counter_mirror_bytes"] == counter_bytes(m)
    assert st["shipped_bytes_total"] == counter_bytes(m)
    return st


def _carry(lanes):
    return [lane_from_reference(
        ln.const, ln.init, ln.batch, ln.order, dtype_name=ln.dtype_name,
        spread_alg=ln.spread_alg, node_ids=ln.matrix.node_ids,
        table_version=ln.table_version, delta_src=ln.delta_src,
        device="cpu") for ln in lanes]


ROUTES = {"wave": (slice(0, 8), False), "dense": (slice(8, 12), False),
          "mesh": (slice(0, 12), True)}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_ledger_parity_and_split_match_reference(route, monkeypatch):
    """Two generations of the mesh test's world (the second after an
    alloc write, so the version chain promotes or reuses) through both
    packages: each ledger reconciles with its dispatch_bytes_total, and
    the port's groups -- shipped and resident bytes and arrays -- and its
    per-cell rows equal the reference's."""
    sl, use_mesh = ROUTES[route]
    # off, the reference's wave route stays on one device too
    monkeypatch.setenv("NOMAD_TPU_MESH", "1" if use_mesh else "0")
    if use_mesh:
        _needs_8_devices()
        monkeypatch.setenv("NOMAD_TPU_CONST_CACHE_MIN_BYTES", "256")
        monkeypatch.setenv("NOMAD_TPU_TORCH_CONST_CACHE_MIN_BYTES", "256")
    h, nodes, filler, lanes = _sched_world()
    lanes = [copy.copy(ln) for ln in lanes[sl]]
    for ln in lanes:
        ln.init = type(ln.init)(*(np.array(a) for a in ln.init))
    cells = CELLS if use_mesh else "cpu"
    for g in range(2):
        if g:
            h.state.upsert_allocs([mock.alloc_for(filler, nodes[1],
                                                  index=900)])
            for ln in lanes:
                ln.delta_src = (h.state, h.state.latest_index())
        want = ref_batch.fuse_and_solve(lanes, use_mesh=use_mesh)
        got = batch.fuse_and_solve(_carry(lanes), device=cells)
        for w, p in zip(want, got):
            np.testing.assert_array_equal(p[0], w[0])
    ref_st = assert_parity(ref_xferobs, ref_metrics)
    st = assert_parity()
    assert st["groups"] == ref_st["groups"]
    assert st["per_shard"] == ref_st["per_shard"]
    assert st["shard_parity_bytes"] == 0 and xferobs.shard_parity() == 0
    assert st["dispatches"] == ref_st["dispatches"]
    assert st["fetched_bytes_total"] > 0
    groups = set(st["groups"])
    if route == "wave":
        assert groups == {"compact"}
    elif route == "dense":
        assert {"const", "init", "batch"} <= groups
    else:
        assert {"mesh_const", "mesh_init", "mesh_batch"} <= groups
        assert st["per_shard"]
    assert resident.stats()["bytes_shipped_total"] == \
        constcache.stats()["bytes_shipped_total"]


SERVER_WORLDS = [("tier", (1, 5, 3, 0)), ("tier", (2, 40, 30, 1)),
                 ("tier", (4, 40, 30, 201)), ("tier", (5, 24, 12, 42)),
                 ("system", (0, False))]


@pytest.mark.parametrize("kind,arg", SERVER_WORLDS,
                         ids=[f"{k}-{a}" for k, a in SERVER_WORLDS])
def test_ledger_parity_through_both_servers(kind, arg, monkeypatch):
    """A world through both Servers (the reference's mesh off, so both
    run one device): both ledgers reconcile, and the port's split is the
    reference's but for the system fit's upload, which only the port
    counts."""
    monkeypatch.setenv("NOMAD_TPU_MESH", "0")
    if kind == "tier":
        store, ev, _ = tier_world(*arg, "tpu-binpack")
    else:
        store, ev = system_world(*arg, "tpu-binpack")
    run_servers(store, [ev])
    ref_st = assert_parity(ref_xferobs, ref_metrics)
    st = assert_parity()
    groups = dict(st["groups"])
    system = groups.pop("system", None)
    assert (system is not None) == (kind == "system")
    assert groups == ref_st["groups"]
    if kind == "tier" and arg[0] == 5:
        assert set(st["fetches"]) & {"wave_preempt", "fused_preempt"}


def test_ledger_parity_lp_tier(monkeypatch):
    """The LP tier's generation: its inputs ship under ``lpq`` and the
    greedy rest through the fused transport; parity holds."""
    store, evals = lpq_world(8, 4000, 8192, 4, 3, "lpq-xfer")
    run_servers(store, evals)
    st = assert_parity()
    assert "lpq" in st["groups"] and "lpq" in st["fetches"]
    assert st["groups"]["lpq"]["shipped_bytes"] > 0


def test_kill_switch_bitwise_parity(monkeypatch):
    """NOMAD_TPU_TORCH_XFEROBS=0: the same committed state as with the
    ledger on, and every entry point a no-op."""
    store, ev, _ = tier_world(2, 40, 30, 1, "tpu-binpack")
    _, on = run_servers(store, [ev])
    want = server_digest(on)
    reset_globals()
    monkeypatch.setenv("NOMAD_TPU_TORCH_XFEROBS", "0")
    store, ev, _ = tier_world(2, 40, 30, 1, "tpu-binpack")
    _, off = run_servers(store, [ev])
    assert server_digest(off) == want
    xferobs.note_payload("const", 123)
    xferobs.note_fetch(456, "wave")
    xferobs.begin_dispatch(E=1)
    xferobs.end_dispatch(1.0)
    assert xferobs.state() == {"enabled": False}
    assert xferobs.parity() == 0 and xferobs.shard_parity() == 0
    assert xferobs.mark() == 0 and xferobs.span_tags(0) == {}
    assert xferobs.counter_events() == []
    assert xferobs.bench_fields() == {"xferobs_enabled": False}
    monkeypatch.delenv("NOMAD_TPU_TORCH_XFEROBS")
    assert xferobs._LEDGER.snapshot()["dispatches"] == 0


def test_tunnel_model_recovers_rtt_and_bandwidth():
    fits = []
    for mod in (ref_xferobs, xferobs):
        m = mod._TunnelModel()
        # wall_ms = 5 ms RTT + bytes at 1 MB/s (0.001 ms a byte)
        for nbytes in (1000, 2000, 5000, 10000, 20000, 50000, 100000,
                       200000):
            m.add(nbytes, 5.0 + nbytes * 0.001)
        m.add(50000, 5000.0)             # a build-slow sample: left out
        flat = mod._TunnelModel()
        flat.add(1000, 7.0)
        flat.add(1000, 9.0)
        fits.append((m.fit(), flat.fit()))
    assert fits[1] == fits[0]
    fit, flat = fits[1]
    assert abs(fit["rtt_ms"] - 5.0) < 1e-6
    assert abs(fit["bw_mbps"] - 1.0) < 1e-6
    assert fit["samples"] == 8 and fit["skipped_slow"] == 1
    assert fit["residual_rms_ms"] < 1e-6
    assert abs(fit["crossover_bytes"] - 5000) <= 1
    assert flat["bw_mbps"] is None and flat["crossover_bytes"] is None
    assert abs(flat["rtt_ms"] - 8.0) < 1e-6


def test_tunnel_fit_feeds_metrics_and_split_spans():
    ctx = tracer.begin("xfer-split")
    with tracer.activate(ctx):
        for i in range(10):
            xferobs.begin_dispatch(E=2, in_flight=0)
            xferobs.note_payload("const", 10000 * (i + 1))
            xferobs.note_shipped(10000 * (i + 1))
            xferobs.end_dispatch(2.0 + 0.0001 * 10000 * (i + 1),
                                 time.time())
    tracer.end("xfer-split")
    snap = metrics.snapshot()
    assert snap["gauges"]["nomad.xfer.rtt_ms"]["count"] > 0
    assert snap["gauges"]["nomad.xfer.bw_mbps"]["count"] > 0
    assert snap["counters"]["nomad.xfer.dispatches"] == 10
    names = [s["name"] for s in tracer.get("xfer-split")["spans"]]
    assert "solver.xfer_transfer" in names and "solver.xfer_compute" in names
    assert _STAGE_OF["solver.xfer_transfer"] == ("dispatch.transfer", "busy")
    assert _STAGE_OF["solver.xfer_compute"] == ("dispatch.compute", "busy")
    assert xferobs.parity() == 0
    fields = xferobs.bench_fields()
    assert fields["xfer_fit_samples"] == 10 and fields["xfer_rtt_ms"] >= 0


def test_residency_map_matches_resident_stats():
    a = np.full(4096, 1.0, dtype=np.float32)
    b = np.full(4096, 2.0, dtype=np.float32)
    resident.device_put_cached([a, b], device="cpu", version=7,
                               tags=["const", "const"])
    resident.device_put_cached([np.array(a), np.array(b)], device="cpu",
                               version=7, tags=["const", "const"])
    rows = resident.residency()
    assert len(rows) == 2
    for row in rows:
        assert (row["bytes"], row["version"], row["hits"]) == (
            a.nbytes, 7, 1)
    rep = xferobs.residency_report()
    rs = resident.stats()
    assert rep["entries"] == rs["entries"] == 2
    assert rep["resident_bytes"] == rs["resident_bytes"] == 2 * a.nbytes
    assert rep["resident_hwm_bytes"] == 2 * a.nbytes
    assert sum(r["hits"] for r in rep["top"]) == rs["hits"] == 2
    st = assert_parity()
    assert st["groups"]["const"]["resident_bytes"] == 2 * a.nbytes
    assert st["groups"]["const"]["shipped_bytes"] == 2 * a.nbytes
    assert st["shipped_bytes_total"] == rs["bytes_shipped_total"]
    resident.invalidate_all("test")
    rep2 = xferobs.residency_report()
    assert rep2["resident_bytes"] == 0
    assert rep2["resident_hwm_bytes"] == 2 * a.nbytes


def test_fuse_dispatch_span_carries_xfer_tags():
    _, _, _, lanes = _sched_world()
    lane = _carry(lanes[:1])[0]
    ctx = tracer.begin("xfer-fuse")
    barrier = batch.SolveBarrier(participants=1, depth=1, device="cpu")
    with tracer.activate(ctx):
        barrier.solve(lane)
    tr = tracer.get("xfer-fuse")
    tracer.end("xfer-fuse")
    spans = {s["name"]: s for s in tr["spans"]}
    tags = spans["solver.fuse_dispatch"]["tags"]
    assert tags["xfer_shipped_bytes"] > 0 and "xfer_actual_ms" in tags
    assert {"solver.dispatch", "solver.constcache"} <= set(spans)


def test_counter_events_render_perfetto_tracks():
    for i in range(3):
        xferobs.begin_dispatch(E=1, in_flight=i)
        xferobs.note_payload("const", 1000)
        xferobs.note_shipped(1000)
        xferobs.end_dispatch(1.0, time.time())
    events = xferobs.counter_events()
    assert {e["name"] for e in events} == {
        "xfer shipped bytes", "xfer resident bytes",
        "xfer in-flight dispatches"}
    assert all(e["ph"] == "C" for e in events)


def test_bench_fields_over_repeated_generations():
    _, _, _, lanes = _sched_world()
    port_lanes = _carry(lanes[:2])
    for _ in range(9):
        batch.fuse_and_solve(port_lanes, device="cpu")
    fields = xferobs.bench_fields()
    assert fields["xferobs_enabled"] is True
    assert fields["xfer_ledger_parity"] == 0
    assert fields["xfer_payload_bytes_shipped"] > 0
    assert fields["xfer_payload_bytes_resident"] > 0
    assert fields["xfer_dispatches"] == 9
    assert fields["xfer_shipped_bytes_per_dispatch"] > 0
    assert "xfer_rtt_ms" in fields and fields["xfer_fit_samples"] == 9
