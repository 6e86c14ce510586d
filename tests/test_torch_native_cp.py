"""The native control plane's switch (NOMAD_TPU_TORCH_NATIVE_CP, default
on) held against its plain paths and the JAX package: the cases of
tests/test_native_cp.py -- verify decisions both ways, the snapshot's
journal-advanced alloc map against the whole copy, the journal-gap
fallback, the lazy alloc metric's encoding and forwarding, and a
scheduler run both ways -- and the port against the reference with both
at their defaults: equal placements, plans and native counters.

Worlds come from each package's own mock with the id streams re-seeded
alike, or from the reference's store carried to the port."""
import copy
import dataclasses
import json
import random
import threading
from types import SimpleNamespace

import numpy as np
import pytest

from nomad_tpu import mock as ref_mock
from nomad_tpu import structs as ref_structs
from nomad_tpu.server import plan_apply as ref_plan_apply
from nomad_tpu.server import telemetry as ref_tel
from nomad_tpu.state import StateStore as RefStateStore
from nomad_tpu.structs.codec import encode as ref_encode
from nomad_tpu.structs.job import reseed_ids as ref_reseed_ids

from nomad_tpu_torch import mock as port_mock
from nomad_tpu_torch import native
from nomad_tpu_torch import structs as port_structs
from nomad_tpu_torch.api.http import to_jsonable
from nomad_tpu_torch.carry import store_from_reference, struct_from_reference
from nomad_tpu_torch.scheduler.harness import Harness
from nomad_tpu_torch.server import plan_apply as port_plan_apply
from nomad_tpu_torch.server import telemetry as port_tel
from nomad_tpu_torch.state.restore import dump_state
from nomad_tpu_torch.state.store import StateStore as PortStateStore
from nomad_tpu_torch.state.store import _DeltaAllocs
from nomad_tpu_torch.structs.codec import encode

from test_torch_native import ensure_reference_native
from test_torch_scheduler import (  # noqa: F401
    Route, assert_same_runs, fresh_state, placements, run_both, tier_world)

REF = SimpleNamespace(mock=ref_mock, st=ref_structs, pa=ref_plan_apply,
                      Store=RefStateStore, reseed=ref_reseed_ids,
                      tel=ref_tel)
PORT = SimpleNamespace(mock=port_mock, st=port_structs, pa=port_plan_apply,
                       Store=PortStateStore, reseed=port_structs.reseed_ids,
                       tel=port_tel)


@pytest.fixture(autouse=True)
def _defaults(monkeypatch):
    """Both packages at their defaults (the switch on), the reference's
    library loaded, both registries empty."""
    ensure_reference_native()
    monkeypatch.delenv("NOMAD_TPU_NATIVE_CP", raising=False)
    monkeypatch.delenv("NOMAD_TPU_TORCH_NATIVE_CP", raising=False)
    for t in (ref_tel, port_tel):
        t.metrics.reset()
    yield
    for t in (ref_tel, port_tel):
        t.metrics.reset()


def native_counters(P):
    return {k: v for k, v in P.tel.metrics.snapshot()["counters"].items()
            if k.startswith("nomad.native.")}


# --------------------------------------------------------------------------
# verify: the native pre-pass against the Python one and the reference's

def verify_world(P, seed, n_nodes=12):
    """Two jobs' allocs on every node, a third of them client-complete,
    with seeded cpu asks; fixed ids."""
    P.reseed(seed)
    rng = random.Random(seed)
    store = P.Store()
    nodes = []
    for i in range(n_nodes):
        n = P.mock.node()
        n.id = f"ncp-node-{i:04d}"
        n.compute_class()
        store.upsert_node(n)
        nodes.append(n)
    jobs = [P.mock.job(id=f"ncp-job-{j}") for j in range(2)]
    for j in jobs:
        store.upsert_job(j)
    allocs = []
    for j in jobs:
        for i, n in enumerate(nodes):
            a = P.mock.alloc_for(j, n, i)
            a.id = f"{j.id}-alloc-{i:04d}".ljust(36, "0")
            a.allocated_resources.tasks["web"].cpu_shares = \
                rng.choice([500, 1000, 1500])
            a.client_status = "running" if i % 3 else "complete"
            allocs.append(a)
    store.upsert_allocs(allocs)
    return store, nodes, jobs, allocs


def verify_plans(P, seed, nodes, jobs, allocs):
    """(plan, in-flight result or None) pairs: stops, preemptions and
    in-place replacements of the world's allocs, new placements with
    seeded asks (some past a node's free cpu), and an in-flight plan
    whose placements and stops overlay the snapshot."""
    rng = random.Random(seed + 1)
    st = P.st
    by_node = {}
    for a in allocs:
        by_node.setdefault(a.node_id, []).append(a)
    out = []
    for k in range(4):
        plan = st.Plan(eval_id=f"ncp-eval-{seed:04d}-{k:04d}".ljust(36, "0"),
                       priority=50, job=jobs[k % 2])
        for i, n in enumerate(nodes):
            mine = by_node[n.id]
            if rng.random() < 0.3:
                stop = copy.copy(mine[0])
                stop.desired_status = "stop"
                plan.node_update.setdefault(n.id, []).append(stop)
            if rng.random() < 0.2:
                victim = copy.copy(mine[1])
                victim.desired_status = "evict"
                plan.node_preemptions.setdefault(n.id, []).append(victim)
            for j in range(rng.choice([0, 1, 2])):
                a = P.mock.alloc_for(jobs[k % 2], n, 100 + j)
                a.id = f"ncp-new-{seed}-{k}-{i}-{j}".ljust(36, "0")
                a.allocated_resources.tasks["web"].cpu_shares = \
                    rng.choice([100, 800, 2500])
                plan.append_alloc(a)
            if rng.random() < 0.2:
                plan.append_alloc(copy.copy(mine[1]))    # in place
        inflight = None
        if k % 2:
            inflight = st.PlanResult(node_update={}, node_allocation={},
                                     node_preemptions={})
            for i, n in enumerate(nodes[::3]):
                a = P.mock.alloc_for(jobs[0], n, 200 + i)
                a.id = f"ncp-inflight-{seed}-{k}-{i}".ljust(36, "0")
                a.allocated_resources.tasks["web"].cpu_shares = 700
                inflight.node_allocation[n.id] = [a]
                inflight.node_update[n.id] = [by_node[n.id][1]]
        out.append((plan, inflight))
    return out


def verify_decisions(P, seed, monkeypatch, switch):
    if switch is not None:
        monkeypatch.setenv("NOMAD_TPU_TORCH_NATIVE_CP", switch)
    store, nodes, jobs, allocs = verify_world(P, seed)
    planner = P.pa.Planner(store)
    try:
        out = []
        for plan, inflight in verify_plans(P, seed, nodes, jobs, allocs):
            snap = store.snapshot()
            if inflight is not None:
                snap = P.pa._OverlaySnapshot(snap, inflight)
            rejects, fit = planner._fast_check(snap, plan,
                                               [n.id for n in nodes])
            result = planner._evaluate_plan(snap, plan)
            out.append((sorted(rejects.items()), sorted(fit),
                        sorted(result.rejected_nodes),
                        {nid: sorted(a.id for a in al) for nid, al in
                         sorted(result.node_allocation.items())}))
        return out, native_counters(P)
    finally:
        planner.shutdown()
        monkeypatch.delenv("NOMAD_TPU_TORCH_NATIVE_CP", raising=False)


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_plan_verify_switch_parity(seed, monkeypatch):
    """The native pre-pass decides as the Python pre-pass does, and as
    the reference's native pre-pass, on plans with stops, preemptions,
    in-place replacements and an in-flight overlay; only the native
    path counts its hits."""
    on, on_counts = verify_decisions(PORT, seed, monkeypatch, None)
    port_tel.metrics.reset()
    off, off_counts = verify_decisions(PORT, seed, monkeypatch, "0")
    ref, ref_counts = verify_decisions(REF, seed, monkeypatch, None)
    assert on == off == ref
    assert any(d[0] for d in on) and any(d[1] for d in on)
    assert on_counts["nomad.native.verify_hits"] >= 4
    assert on_counts["nomad.native.verify_hits"] \
        == ref_counts["nomad.native.verify_hits"]
    assert "nomad.native.verify_hits" not in off_counts


def test_plan_verify_plain_form_matches_library(monkeypatch):
    """The native pre-pass with its C call replaced by the sequential
    numpy form decides identically (the reference's fallback case)."""
    with_lib, _ = verify_decisions(PORT, 7, monkeypatch, None)
    monkeypatch.setattr(native, "verify_plan_native",
                        native.verify_plan_plain)
    plain, _ = verify_decisions(PORT, 7, monkeypatch, None)
    assert with_lib == plain


# --------------------------------------------------------------------------
# snapshots: the journal-advanced map against the whole copy

def _alloc_world(n_allocs=30):
    store = PortStateStore()
    n = port_mock.node()
    store.upsert_node(n)
    job = port_mock.job()
    store.upsert_job(job)
    allocs = [port_mock.alloc_for(job, n, i) for i in range(n_allocs)]
    store.upsert_allocs(allocs)
    return store, n, job, allocs


def assert_same_map(view, store):
    """Same keys, same objects, same order as dict(store._allocs)."""
    want = dict(store._allocs)
    assert list(view) == list(want)
    assert len(view) == len(want)
    assert [id(v) for v in view.values()] == [id(v) for v in want.values()]
    assert [(k, id(v)) for k, v in view.items()] \
        == [(k, id(v)) for k, v in want.items()]
    for k, v in want.items():
        assert k in view and view[k] is v and view.get(k) is v
    assert "no-such-alloc" not in view and view.get("no-such-alloc") is None


def test_snapshot_view_matches_whole_copy(monkeypatch):
    """Through replacements, deletions, insertions, a deletion inserted
    again and a second advance from the view, the snapshot's map holds
    the store's dict -- keys, objects, iteration order -- and an earlier
    snapshot keeps its own."""
    store, n, job, allocs = _alloc_world()
    snap1 = store.snapshot()            # the first: a whole copy
    assert type(snap1._allocs) is dict
    before = list(snap1._allocs)

    repl = [port_mock.alloc_for(job, n, i) for i in range(5)]
    for old, new in zip(allocs[:5], repl):
        new.id = old.id
    store.upsert_allocs(repl)
    store.delete_allocs([allocs[10].id, allocs[11].id])
    store.upsert_allocs([port_mock.alloc_for(job, n, 40 + i)
                         for i in range(3)])
    again = port_mock.alloc_for(job, n, 11)
    again.id = allocs[11].id            # deleted, then inserted again
    store.upsert_allocs([again])
    snap2 = store.snapshot()
    assert isinstance(snap2._allocs, _DeltaAllocs)
    assert_same_map(snap2._allocs, store)
    assert list(snap1._allocs) == before
    mid = list(snap2._allocs)

    extra = port_mock.alloc_for(job, n, 60)
    store.upsert_allocs([extra])
    store.delete_allocs([repl[2].id, extra.id])
    store.update_alloc_desired_transition([allocs[20].id])
    snap3 = store.snapshot()            # advanced from the view
    assert isinstance(snap3._allocs, _DeltaAllocs)
    assert_same_map(snap3._allocs, store)
    assert list(snap2._allocs) == mid and list(snap1._allocs) == before

    # the snapshot's readers see what a whole copy shows
    for snap in (snap3,):
        assert [a.id for a in snap.allocs()] == list(store._allocs)
        assert [a.id for a in snap.allocs_by_node(n.id)] == \
            [a.id for a in store.allocs_by_node(n.id)]
        assert [a.id for a in snap.allocs_by_job(job.namespace, job.id)] \
            == [a.id for a in store.allocs_by_job(job.namespace, job.id)]
        assert snap.alloc_by_id(allocs[20].id) is store._allocs[
            allocs[20].id]
    counts = native_counters(PORT)
    assert counts == {"nomad.native.snapshot_fallbacks": 1,
                      "nomad.native.snapshot_hits": 2}

    # a write to another table reuses the frozen map
    store.upsert_job(port_mock.job())
    assert store.snapshot()._allocs is snap3._allocs
    # the switch off: plain whole copies (mutate first: an unchanged
    # index serves the cached snapshot)
    monkeypatch.setenv("NOMAD_TPU_TORCH_NATIVE_CP", "0")
    store.upsert_allocs([port_mock.alloc_for(job, n, 50)])
    snap4 = store.snapshot()
    assert type(snap4._allocs) is dict
    assert list(snap4._allocs.items()) == list(store._allocs.items())


def test_snapshot_overlay_budget_flattens():
    """An overlay past max(1024, base / 8) entries goes back to a whole
    copy (the reference's budget)."""
    store, n, job, _ = _alloc_world(10)
    store.snapshot()
    store.upsert_allocs([port_mock.alloc_for(job, n, 100 + i)
                         for i in range(1000)])
    s = store.snapshot()
    assert isinstance(s._allocs, _DeltaAllocs)
    store.upsert_allocs([port_mock.alloc_for(job, n, 2000 + i)
                         for i in range(30)])
    s2 = store.snapshot()
    assert type(s2._allocs) is dict
    assert list(s2._allocs) == list(store._allocs)
    assert native_counters(PORT) == {"nomad.native.snapshot_fallbacks": 2,
                                     "nomad.native.snapshot_hits": 1}


@pytest.mark.parametrize("gap", ["restore", "journal_overflow",
                                 "replace_allocs"])
def test_snapshot_journal_gap_falls_back(gap, monkeypatch):
    """A span the journal cannot cover -- a restore, a journal that
    wrapped past the last snapshot, a wholesale replace -- gives a whole
    copy, never a stale view."""
    monkeypatch.setenv("NOMAD_TPU_TORCH_DELTA_JOURNAL", "8")
    store, n, job, allocs = _alloc_world(10)
    store.snapshot()
    if gap == "restore":
        blob = dump_state(store)
        store.upsert_allocs([port_mock.alloc_for(job, n, 99)])
        store.restore_from_snapshot(blob)
    elif gap == "journal_overflow":
        for i in range(12):
            store.upsert_allocs([port_mock.alloc_for(job, n, 50 + i)])
    else:
        store.replace_allocs(allocs[:4])
    s = store.snapshot()
    assert type(s._allocs) is dict
    assert list(s._allocs) == list(store._allocs)
    assert native_counters(PORT)["nomad.native.snapshot_fallbacks"] == 2


# --------------------------------------------------------------------------
# the lazy alloc metric

def _base_metric(P):
    base = P.st.AllocMetric(nodes_in_pool=12)
    base.filter_node("c1", "missing-driver")
    base.exhausted_node("n9", "c2", "memory")
    base.nodes_available["dc1"] = 7
    return base


@pytest.mark.parametrize("preempt", [None, -0.5])
def test_lazy_alloc_metric_encodes_identically(preempt):
    """The stub encodes as the eager copy does, and as the reference's
    stub, through the codec and the HTTP encoder."""
    base = _base_metric(PORT)
    eager = base.copy_for_alloc()
    eager.nodes_evaluated = 5
    eager.score_node("node-1", "normalized-score", 0.75)
    if preempt is not None:
        eager.score_node("node-1", "preemption", preempt)
    lazy = port_structs.LazyAllocMetric(base, "node-1", 0.75, 5, preempt)
    ref_lazy = ref_structs.LazyAllocMetric(_base_metric(REF), "node-1",
                                           0.75, 5, preempt)
    assert encode(lazy) == encode(eager) == ref_encode(ref_lazy)
    assert json.dumps(to_jsonable(lazy)) == json.dumps(to_jsonable(eager))


def test_lazy_alloc_metric_attribute_forwarding():
    lazy = port_structs.LazyAllocMetric(_base_metric(PORT), "node-2", 0.25,
                                        3)
    assert "lazy" in repr(lazy)
    assert lazy.nodes_evaluated == 3
    assert lazy.scores == {"node-2.normalized-score": 0.25}
    assert lazy.nodes_in_pool == 12
    assert "hydrated" in repr(lazy)
    # asdict on the owning dataclass deep-copies the stub as a hydrated
    # AllocMetric, as the eager field would deep-copy as itself
    a = port_mock.alloc_for(port_mock.job(), port_mock.node(), 0)
    a.metrics = port_structs.LazyAllocMetric(_base_metric(PORT), "node-2",
                                             0.25, 3)
    d = dataclasses.asdict(a)
    assert isinstance(d["metrics"], port_structs.AllocMetric)
    assert d["metrics"].nodes_evaluated == 3
    assert isinstance(copy.deepcopy(a).metrics, port_structs.AllocMetric)
    # a shallow copy of the alloc shares the stub
    assert copy.copy(a).metrics is a.metrics


def test_lazy_alloc_metric_scalars_frozen_at_construction():
    """Later selects of the eval change the base's scalars: the stub
    keeps the values the eager copy took when the alloc was placed."""
    base = _base_metric(PORT)
    lazy = port_structs.LazyAllocMetric(base, "n", 0.5, 2)
    eager = base.copy_for_alloc()
    base.nodes_in_pool = 99
    base.filter_node("c3", "x")
    base.allocation_time_ns = 12345
    assert lazy.nodes_in_pool == eager.nodes_in_pool == 12
    assert lazy.nodes_filtered == eager.nodes_filtered
    assert lazy.allocation_time_ns == eager.allocation_time_ns == 0


def test_lazy_alloc_metric_hydrates_once_under_a_race():
    """Threads hydrating one stub at once all get the same record."""
    for _ in range(20):
        lazy = port_structs.LazyAllocMetric(_base_metric(PORT), "n", 0.5, 2)
        go = threading.Barrier(8)
        got = []

        def read():
            go.wait(timeout=30)
            got.append(lazy.__nomad_hydrate__())

        threads = [threading.Thread(target=read) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive(), "a hydrating thread did not end"
        assert len({id(m) for m in got}) == 1 and len(got) == 8


# --------------------------------------------------------------------------
# the scheduler end to end

def run_port(monkeypatch, ref_store, ev, kind, switch):
    """One port Harness run of ``ev`` through the barrier on a store
    carried from ``ref_store``, with the switch as given."""
    if switch is None:
        monkeypatch.delenv("NOMAD_TPU_TORCH_NATIVE_CP", raising=False)
    else:
        monkeypatch.setenv("NOMAD_TPU_TORCH_NATIVE_CP", switch)
    port_tel.metrics.reset()
    memo = {}
    store = store_from_reference(ref_store.snapshot(), memo)
    pev = struct_from_reference(ev, memo)
    h = Harness(store)
    port_structs.reseed_ids(4242)
    assert h.process(kind, pev, **Route("barrier").port_kw()) is None
    monkeypatch.delenv("NOMAD_TPU_TORCH_NATIVE_CP", raising=False)
    return h, native_counters(PORT)


def _outputs(h):
    """What readers see: the plans' placements, the HTTP encoding of
    every alloc, a state dump and the snapshot's alloc map, as text."""
    snap = h.state.snapshot()
    return dict(
        placements=placements(h),
        http=json.dumps(to_jsonable(h.state.allocs())),
        dump=json.dumps(dump_state(h.state)),
        snapshot=json.dumps([encode(a) for a in snap.allocs()]))


@pytest.mark.parametrize("tier,n_nodes,count,seed", [(2, 40, 30, 1),
                                                     (3, 40, 30, 100)])
def test_scheduler_end_to_end_switch_parity(tier, n_nodes, count, seed,
                                            monkeypatch):
    """One tpu-binpack eval through the port with the switch on and off:
    equal placements, and byte-equal HTTP reads, state dumps and
    snapshot encodings; the placed allocs carry lazy stubs only with the
    switch on."""
    ref_store, ev, kind = tier_world(tier, n_nodes, count, seed,
                                     "tpu-binpack")
    on, on_counts = run_port(monkeypatch, ref_store, ev, kind, None)
    stubs = [a.metrics for p in on.plans
             for al in p.node_allocation.values() for a in al]
    assert stubs and all(type(m) is port_structs.LazyAllocMetric
                         for m in stubs)
    off, off_counts = run_port(monkeypatch, ref_store, ev, kind, "0")
    assert all(type(a.metrics) is port_structs.AllocMetric
               for p in off.plans for al in p.node_allocation.values()
               for a in al)
    want = _outputs(off)
    got = _outputs(on)
    for key in want:
        assert got[key] == want[key], key
    assert on_counts["nomad.native.materialize_hits"] == len(stubs)
    assert off_counts == {}


def test_lean_alloc_metrics_count_as_materialize_fallbacks(monkeypatch):
    ref_store, ev, kind = tier_world(2, 40, 30, 1, "tpu-binpack")
    monkeypatch.setenv("NOMAD_TPU_TORCH_LEAN_ALLOC_METRICS", "1")
    h, counts = run_port(monkeypatch, ref_store, ev, kind, None)
    placed = [a for p in h.plans for al in p.node_allocation.values()
              for a in al]
    assert placed and counts["nomad.native.materialize_fallbacks"] \
        == len(placed)
    for a in placed:
        m = a.metrics
        assert type(m) is port_structs.AllocMetric
        assert m.nodes_in_pool > 0 and not m.class_filtered
        assert list(m.scores) == [f"{a.node_id}.normalized-score"]


@pytest.mark.parametrize("tier,n_nodes,count,seed", [(3, 40, 30, 100),
                                                     (4, 40, 30, 201)])
def test_port_and_reference_at_defaults_agree(tier, n_nodes, count, seed):
    """Both packages at their defaults (native control plane on, the
    reference's library loaded): equal plans, eval updates, stores and
    metrics, and equal nomad.native.* counters. The worlds hold allocs:
    in a world with none the reference's first advance reads an empty
    journal from allocs index 0 (an overflow, so a whole copy), which a
    store carried at the snapshot's index does not replay."""
    ref_store, ev, kind = tier_world(tier, n_nodes, count, seed,
                                     "tpu-binpack")
    # both stores hold a snapshot before the run (the carry takes the
    # reference's), so each run's first snapshot advances from one
    port_store = store_from_reference(ref_store.snapshot(), {})
    port_store.snapshot()
    for t in (ref_tel, port_tel):
        t.metrics.reset()
    rh, ph, r, p = run_both(ref_store, ev, kind, Route("barrier"),
                            port_store=port_store)
    assert r is None and p is None and placements(ph)
    assert_same_runs(rh, ph)
    placed = [a.metrics for pl in ph.plans
              for al in pl.node_allocation.values() for a in al]
    assert all(type(m) is port_structs.LazyAllocMetric for m in placed)
    got, want = native_counters(PORT), native_counters(REF)
    assert got == want and got["nomad.native.materialize_hits"] \
        == len(placed)
    assert np.isfinite([m.scores[k] for m in placed
                        for k in m.scores]).all()
