"""The port's snapshot-isolation sanitizer (nomad_tpu_torch/statecheck.py)
on the CPU: the reference's own tests (tests/test_statecheck.py, less
the HTTP, CLI and bench-stamp surfaces; the raft snapshot restore is the
port store's ``replace_allocs``), each planted fault found, and the same
verdict as the reference's checker on the mirrored scenarios."""
import numpy as np
import pytest
import torch

from nomad_tpu import mock as ref_mock
from nomad_tpu import statecheck as ref_statecheck
from nomad_tpu.state.store import StateStore as RefStateStore
from nomad_tpu.structs import PlanResult as RefPlanResult
from nomad_tpu_torch import mock, statecheck
from nomad_tpu_torch.state.alloc_table import AllocTable
from nomad_tpu_torch.state.store import StateStore
from nomad_tpu_torch.structs import PlanResult


@pytest.fixture(autouse=True)
def _clean_checker():
    """Every test leaves the original store and table methods restored
    and both packages' checker state empty, pass or fail."""
    yield
    statecheck.disable()
    statecheck._reset_for_tests()
    ref_statecheck.disable()
    ref_statecheck._reset_for_tests()


def _world(n_nodes=2, job_id="sc-job", m=mock, store_cls=StateStore):
    s = store_cls()
    nodes = []
    for k in range(n_nodes):
        n = m.node()
        n.id = f"sc-node-{k:04d}"
        n.compute_class()
        s.upsert_node(n)
        nodes.append(n)
    job = m.job(id=job_id)
    return s, nodes, job


_METHODS = ("fold_verify", "_fold_verify_all", "upsert", "upsert_many",
            "remove", "register_node")


# ----------------------------------------------------------------------
# kill switch + parity


def test_killswitch_is_inert(monkeypatch):
    """NOMAD_TPU_TORCH_STATECHECK=0 (or unset) is a true no-op: the
    methods are the originals and no wrapper is observable."""
    monkeypatch.setenv("NOMAD_TPU_TORCH_STATECHECK", "0")
    statecheck.maybe_install_from_env()
    assert not statecheck.enabled()
    for name in _METHODS:
        assert not getattr(getattr(AllocTable, name),
                           "_statecheck_wrapped", False), name
    assert StateStore._bump.__qualname__.startswith("StateStore.")
    assert StateStore.apply_plan_results_batch.__qualname__.startswith(
        "StateStore.")
    st = statecheck.state()
    assert st["enabled"] is False and st["reads"] == 0
    with statecheck.eval_scope(None):
        with statecheck.strict_scope("off"):
            pass
    assert statecheck.state()["scopes"] == 0


def test_env_knob_installs(monkeypatch):
    monkeypatch.setenv("NOMAD_TPU_TORCH_STATECHECK", "1")
    statecheck.maybe_install_from_env()
    assert statecheck.enabled()
    assert getattr(AllocTable.upsert, "_statecheck_wrapped", False)
    statecheck.disable()
    assert not getattr(AllocTable.upsert, "_statecheck_wrapped", False)
    assert StateStore._bump.__qualname__.startswith("StateStore.")


def _dispatch_and_commit(i=0):
    """A real dispatch and plan commit: one lane solved on the CPU, then
    placements committed through the store's batch path."""
    from nomad_tpu_torch.solver.service import dispatch_lane
    from nomad_tpu_torch.tensor import pack as tpack
    from test_dispatch_pipeline import build_world, pack_lane
    from test_torch_barrier import _carry

    tpack.reset_pack_caches()
    h, nodes = build_world(8)
    lane = _carry([pack_lane(h, nodes, i)])[0]
    solved = dispatch_lane(lane, device="cpu")
    s, pnodes, job = _world(8, job_id=f"par-job-{i}")
    a = mock.alloc_for(job, pnodes[0])
    idx, outcomes = s.apply_plan_results_batch(
        [(PlanResult(node_allocation={a.node_id: [a]}), None)])
    assert outcomes == [None]
    with s._lock:
        s.alloc_table.fold_verify([n.id for n in pnodes])
    return [np.asarray(x) for x in solved], idx


def test_enabled_cycle_is_bitwise_identical():
    off_solved, off_idx = _dispatch_and_commit(0)
    statecheck.enable()
    try:
        on_solved, on_idx = _dispatch_and_commit(0)
        st = statecheck.state()
    finally:
        statecheck.disable()
    assert off_idx == on_idx
    for a, b in zip(off_solved, on_solved):
        np.testing.assert_array_equal(a, b)
    assert st["torn_reads"] == [] and st["aliasing_writes"] == []
    assert st["reads"] > 0 and st["mutations"] > 0


# ----------------------------------------------------------------------
# (a) torn reads


def test_intra_read_tear_detected():
    """A mutation landing DURING one instrumented read (a writer racing a
    reader without the lock) is a torn read with a witness stack."""
    statecheck.enable()
    s, nodes, job = _world()
    s.upsert_allocs([mock.alloc_for(job, nodes[0])])
    t = s.alloc_table
    extra = mock.alloc_for(job, nodes[1], index=7)

    def racing():
        t.upsert(extra)             # the racing writer
        return AllocTable._fold_inc_get(t)

    t._fold_inc_get = racing
    t.fold_verify([nodes[0].id])
    st = statecheck.state()
    tears = [r for r in st["torn_reads"] if r["op"] == "fold_verify"]
    assert tears and tears[0]["kind"] == "intra-read-tear"
    assert tears[0]["versions"][1] > tears[0]["versions"][0]
    assert "test_torch_statecheck.py" in tears[0]["stack"]


def test_strict_scope_tear_detected():
    from nomad_tpu_torch.server.telemetry import metrics
    metrics.reset()
    statecheck.enable()
    s, nodes, job = _world()
    s.upsert_allocs([mock.alloc_for(job, nodes[0])])
    with statecheck.strict_scope("test.verify"):
        with s._lock:
            s.alloc_table.fold_verify([nodes[0].id])
        s.upsert_allocs([mock.alloc_for(job, nodes[1], index=1)])
        with s._lock:
            s.alloc_table.fold_verify([nodes[0].id])
    st = statecheck.state()
    assert any(r["kind"] == "scope-tear" for r in st["torn_reads"]), \
        st["torn_reads"]
    assert metrics.snapshot()["counters"].get(
        "nomad.statecheck.torn_read", 0) >= 1
    metrics.reset()


def test_eval_scope_drift_is_report_only():
    statecheck.enable()
    s, nodes, job = _world()
    s.upsert_allocs([mock.alloc_for(job, nodes[0])])
    snap = s.snapshot()
    with statecheck.eval_scope(snap):
        with s._lock:
            s.alloc_table.fold_verify([nodes[0].id])
        s.upsert_allocs([mock.alloc_for(job, nodes[1], index=1)])
        with s._lock:
            s.alloc_table.fold_verify([nodes[0].id])
    st = statecheck.state()
    assert st["torn_read_count"] == 0
    assert st["drift_count"] >= 1
    assert st["drifts"][0]["scope"] == "eval"


def test_applier_verify_runs_in_a_strict_scope():
    """The plan applier's verify opens the strict scope: a plan through
    the Planner is clean."""
    from nomad_tpu_torch.server.plan_apply import Planner
    from nomad_tpu_torch.structs import Plan

    statecheck.enable()
    s, nodes, job = _world()
    s.upsert_job(job)
    planner = Planner(s)
    try:
        a = mock.alloc_for(job, nodes[0])
        plan = Plan(eval_id=a.eval_id, priority=50, job=job,
                    node_allocation={nodes[0].id: [a]})
        res = planner.apply(plan)
        assert res.node_allocation
    finally:
        planner.shutdown()
    st = statecheck.state()
    assert st["torn_read_count"] == 0 and st["scopes"] >= 1


# ----------------------------------------------------------------------
# (b) aliasing writes


def test_direct_row_write_detected():
    statecheck.enable()
    s, nodes, job = _world()
    a = mock.alloc_for(job, nodes[0])
    s.upsert_allocs([a])
    t = s.alloc_table
    row = t._row_of[a.id]
    t.cpu[row] += 123.0             # nobody bumped version
    assert statecheck.verify_state() >= 1
    st = statecheck.state()
    assert any(r["kind"] == "row-mutated"
               for r in st["aliasing_writes"]), st["aliasing_writes"]


def test_version_blind_mutation_detected(monkeypatch):
    statecheck.enable()
    s, nodes, job = _world()
    monkeypatch.setitem(statecheck._REAL, "table.upsert",
                        lambda self, alloc: None)
    s.alloc_table.upsert(mock.alloc_for(job, nodes[0]))
    st = statecheck.state()
    assert any(r["kind"] == "version-blind-mutation"
               for r in st["aliasing_writes"]), st["aliasing_writes"]


def test_every_mutator_bumps_version():
    """The port's table counts its mutations as the reference's does."""
    s, nodes, job = _world()
    t = s.alloc_table
    a = mock.alloc_for(job, nodes[0])
    for fn in (lambda: t.register_node(nodes[1]), lambda: t.upsert(a),
               lambda: t.upsert_many([mock.alloc_for(job, nodes[0], k)
                                      for k in range(1, 10)]),
               lambda: t.remove(a.id)):
        v0 = t.version
        fn()
        assert t.version > v0
    v0 = t.version
    t.remove("no-such-alloc")
    t.upsert_many([])
    assert t.version == v0


def test_published_array_thaw_and_mutation_detected():
    from nomad_tpu_torch.server.telemetry import metrics
    metrics.reset()
    statecheck.enable()
    arr = np.arange(16, dtype=np.float64)
    arr.setflags(write=False)
    statecheck.note_published(arr)
    assert statecheck.state()["aliasing_write_count"] == 0
    arr.setflags(write=True)
    arr[0] = 99.0
    assert statecheck.verify_state() >= 1
    kinds = {r["kind"] for r in statecheck.state()["aliasing_writes"]}
    assert kinds & {"published-thawed", "published-mutated"}, kinds
    assert metrics.snapshot()["counters"].get(
        "nomad.statecheck.aliasing_write", 0) >= 1
    metrics.reset()


def test_unfrozen_publish_detected():
    statecheck.enable()
    statecheck.note_published(np.zeros(8))
    assert any(r["kind"] == "published-writeable"
               for r in statecheck.state()["aliasing_writes"])


def test_fold_view_mutation_detected():
    """_fold_verify_all hands out views of the live fold columns; a
    consumer writing into them corrupts the store's fold."""
    statecheck.enable()
    s, nodes, job = _world()
    s.upsert_allocs([mock.alloc_for(job, nodes[0])])
    with s._lock:
        vc, vm, vd, vs = s.alloc_table._fold_verify_all()
    vc[0] += 7.0
    assert statecheck.verify_state() >= 1
    assert any(r["kind"] == "fold-view-mutated"
               for r in statecheck.state()["aliasing_writes"])


def test_pack_freeze_registers_published_arrays():
    from nomad_tpu_torch.tensor import pack as tpack

    statecheck.enable()
    s, nodes, job = _world(n_nodes=4)
    snap = s.snapshot()
    tpack.reset_pack_caches()
    tpack.pack_nodes_cached(snap.ready_nodes_in_pool(),
                            snap.node_table_index)
    st = statecheck.state()
    assert st["published_arrays"] > 0
    assert st["aliasing_write_count"] == 0
    tpack.reset_pack_caches()


def test_resident_chain_shadow_is_published():
    """The resident set's promotion shadow (its promise about the card's
    buffer) registers as published and frozen."""
    from nomad_tpu_torch.solver import resident

    statecheck.enable()
    resident._reset_for_tests()
    try:
        s, nodes, job = _world()
        arr = np.arange(64, dtype=np.float32)
        resident.chain_apply(("t", "<f4", (64,), 0, "cpu"), arr, s,
                             s.latest_index(),
                             put_fn=lambda a: resident._put(
                                 a, torch.device("cpu")))
        st = statecheck.state()
        assert st["published_arrays"] >= 1
        assert st["aliasing_write_count"] == 0
    finally:
        resident._reset_for_tests()


# ----------------------------------------------------------------------
# (c) journal gaps


def test_journal_gap_detected_and_mark_uncoverable():
    statecheck.enable()
    s, _nodes, _job = _world()
    with s._lock:
        s._bump("allocs")           # silent gap: reported
    st = statecheck.state()
    assert st["journal_gap_count"] == 1
    assert "test_torch_statecheck.py" in st["journal_gaps"][0]["site"]
    with statecheck.mark_uncoverable("test wholesale write"):
        with s._lock:
            s._bump("allocs")       # explicit gap: quiet
    st = statecheck.state()
    assert st["journal_gap_count"] == 1
    assert st["uncoverable_marked"] == 1


def test_replace_allocs_is_an_explicit_gap():
    """The store's wholesale write (the snapshot-restore form) marks
    itself uncoverable: it stays quiet."""
    statecheck.enable()
    s, nodes, job = _world()
    s.upsert_allocs([mock.alloc_for(job, nodes[0])])
    s.replace_allocs([mock.alloc_for(job, nodes[1], index=1)])
    st = statecheck.state()
    assert st["journal_gap_count"] == 0, st["journal_gaps"]
    assert st["uncoverable_marked"] == 1


# ----------------------------------------------------------------------
# (d) write skew


def _skew_batch(m, result_cls, s, nodes, job, same_node):
    a1 = m.alloc_for(job, nodes[0])
    a1.eval_id = "e" * 30 + "1"
    a2 = m.alloc_for(job, nodes[0 if same_node else 1], index=1)
    a2.eval_id = "e" * 30 + "2"
    s.apply_plan_results_batch([
        (result_cls(node_allocation={a1.node_id: [a1]}), None),
        (result_cls(node_allocation={a2.node_id: [a2]}), None)])
    return a1, a2


def test_write_skew_witness_on_overlapping_batch():
    from nomad_tpu_torch.server.telemetry import metrics
    metrics.reset()
    statecheck.enable()
    s, nodes, job = _world()
    a1, a2 = _skew_batch(mock, PlanResult, s, nodes, job, True)
    st = statecheck.state()
    assert st["write_skew_count"] == 1
    rep = st["write_skews"][0]
    assert rep["node"] == nodes[0].id
    assert set(rep["plans"]) == {a1.eval_id, a2.eval_id}
    assert metrics.snapshot()["counters"].get(
        "nomad.statecheck.write_skew", 0) >= 1
    metrics.reset()


def test_disjoint_batch_is_clean():
    statecheck.enable()
    s, nodes, job = _world()
    _skew_batch(mock, PlanResult, s, nodes, job, False)
    assert statecheck.state()["write_skew_count"] == 0


# ----------------------------------------------------------------------
# (e) stale version-keyed memos


def test_stale_matrix_cache_entry_swept():
    from nomad_tpu_torch.tensor import pack as tpack

    statecheck.enable()
    s, nodes, _job = _world()
    latest = s.table_index("nodes")
    assert latest > 0
    with tpack._NODE_MATRIX_LOCK:
        tpack._NODE_MATRIX_CACHE[(latest - 1, ("ghost",))] = object()
    try:
        assert statecheck.verify_state() >= 1
        assert any(r["kind"] == "node_matrix"
                   for r in statecheck.state()["stale_memos"])
    finally:
        tpack.reset_pack_caches()


def test_memo_served_version_mismatch():
    statecheck.enable()
    statecheck.note_memo_served("usage_base", 3, 5)
    st = statecheck.state()
    assert st["stale_memo_count"] == 1
    rep = st["stale_memos"][0]
    assert rep["entry_version"] == 3 and rep["live_version"] == 5
    statecheck.note_memo_served("usage_base", 5, 5)
    assert statecheck.state()["stale_memo_count"] == 1


def test_worker_scope_attributes_to_trace_span():
    from nomad_tpu_torch.server.tracing import tracer

    statecheck.enable()
    s, nodes, job = _world()
    s.upsert_allocs([mock.alloc_for(job, nodes[0])])
    eid = "scope-eval-" + "0" * 20
    ctx = tracer.begin(eid, job=job.id)
    with tracer.activate(ctx):
        with statecheck.strict_scope("test.verify"):
            with s._lock:
                s.alloc_table.fold_verify([nodes[0].id])
            s.upsert_allocs([mock.alloc_for(job, nodes[1], index=1)])
            with s._lock:
                s.alloc_table.fold_verify([nodes[0].id])
    tracer.end(eid, status="complete")
    tears = [r for r in statecheck.state()["torn_reads"]
             if r["kind"] == "scope-tear"]
    assert tears and eid in tears[0]["evals"]


# ----------------------------------------------------------------------
# the same verdict as the reference's checker


def _strict_tear(m, sc, store_cls, result_cls):
    s, nodes, job = _world(m=m, store_cls=store_cls)
    s.upsert_allocs([m.alloc_for(job, nodes[0])])
    with sc.strict_scope("v"):
        with s._lock:
            s.alloc_table.fold_verify([nodes[0].id])
        s.upsert_allocs([m.alloc_for(job, nodes[1], index=1)])
        with s._lock:
            s.alloc_table.fold_verify([nodes[0].id])


def _eval_drift(m, sc, store_cls, result_cls):
    s, nodes, job = _world(m=m, store_cls=store_cls)
    s.upsert_allocs([m.alloc_for(job, nodes[0])])
    with sc.eval_scope(s.snapshot()):
        s.upsert_allocs([m.alloc_for(job, nodes[1], index=1)])
        with s._lock:
            s.alloc_table.fold_verify([nodes[0].id])


def _gap(m, sc, store_cls, result_cls):
    s, _n, _j = _world(m=m, store_cls=store_cls)
    with s._lock:
        s._bump("allocs")


def _marked_gap(m, sc, store_cls, result_cls):
    s, _n, _j = _world(m=m, store_cls=store_cls)
    with sc.mark_uncoverable("t"):
        with s._lock:
            s._bump("allocs")


def _skew(m, sc, store_cls, result_cls):
    s, nodes, job = _world(m=m, store_cls=store_cls)
    _skew_batch(m, result_cls, s, nodes, job, True)


def _disjoint(m, sc, store_cls, result_cls):
    s, nodes, job = _world(m=m, store_cls=store_cls)
    _skew_batch(m, result_cls, s, nodes, job, False)


def _thaw(m, sc, store_cls, result_cls):
    arr = np.arange(4.0)
    arr.setflags(write=False)
    sc.note_published(arr)
    arr.setflags(write=True)


def _stale(m, sc, store_cls, result_cls):
    sc.note_memo_served("usage_base", 1, 2)


def _row_write(m, sc, store_cls, result_cls):
    s, nodes, job = _world(m=m, store_cls=store_cls)
    a = m.alloc_for(job, nodes[0])
    s.upsert_allocs([a])
    s.alloc_table.cpu[s.alloc_table._row_of[a.id]] += 1.0


def _verdict(st):
    return tuple(st[k] > 0 for k in (
        "torn_read_count", "aliasing_write_count", "journal_gap_count",
        "write_skew_count", "stale_memo_count", "drift_count"))


SCENARIOS = {"strict-tear": _strict_tear, "eval-drift": _eval_drift,
             "journal-gap": _gap, "marked-gap": _marked_gap,
             "write-skew": _skew, "disjoint": _disjoint,
             "published-thaw": _thaw, "stale-memo": _stale,
             "row-write": _row_write}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_same_verdict_as_the_reference(name):
    """Each mirrored scenario under the reference's statecheck (its store
    and structs), then under the port's: the same classes found."""
    fn = SCENARIOS[name]
    ref_statecheck.enable()
    try:
        fn(ref_mock, ref_statecheck, RefStateStore, RefPlanResult)
        ref = _verdict(ref_statecheck.state())
    finally:
        ref_statecheck.disable()
        ref_statecheck._reset_for_tests()
    statecheck.enable()
    fn(mock, statecheck, StateStore, PlanResult)
    assert _verdict(statecheck.state()) == ref
