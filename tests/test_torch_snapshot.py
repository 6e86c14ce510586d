"""The port's state dump / restore (nomad_tpu_torch/state/restore.py),
operator snapshot archives (server/snapshot.py) and the Server's
snapshot_save / snapshot_restore held against the JAX package's on the
CPU.

  * dump_state of a port store equals the reference's, table by table
    (and each table's index), after the same writes into both stores;
    each package's blob restores in the other to the same dump.
  * A reference blob restored in the port, then one more job placed:
    the placements equal the reference server's, node for node.
  * The archive cases of tests/test_snapshot_events.py:25-96, 202, 256:
    round trip (and each package reads the other's archive), corruption
    and garbage refused, a save restored into a fresh server, pending
    evals re-enqueued by the new leadership, a restore that does not
    decode leaving the store as it was.
  * The caches across a restore: two servers whose histories differ
    reach the same index; one's archive restored into the other, then a
    job placed, equals a fresh server restored from the same archive
    (the node-matrix cache, the usage memo and the journal).
"""
import copy
import gzip
import itertools
import json
import threading
import time
from pathlib import Path

import pytest
import torch

from nomad_tpu import mock
from nomad_tpu.raft.fsm import dump_state as ref_dump_state
from nomad_tpu.raft.fsm import restore_state as ref_restore_state
from nomad_tpu.server import Server as RefServer
from nomad_tpu.server.snapshot import load_archive as ref_load_archive
from nomad_tpu.server.snapshot import save_archive as ref_save_archive
from nomad_tpu.state import StateStore as RefStateStore
from nomad_tpu.structs import (
    EVAL_STATUS_PENDING, Evaluation, NodePool, ScalingEvent,
    SchedulerConfiguration)
from nomad_tpu.structs.job import reseed_ids as ref_reseed_ids

from nomad_tpu_torch import mock as pmock
from nomad_tpu_torch import structs as pst
from nomad_tpu_torch.carry import store_from_reference, struct_from_reference
from nomad_tpu_torch.server import Server
from nomad_tpu_torch.server.snapshot import load_archive, save_archive
from nomad_tpu_torch.state.restore import dump_state, restore_state
from nomad_tpu_torch.state.store import TABLES, StateStore

from test_torch_server import (  # noqa: F401 -- fresh_state is autouse
    assert_same, fresh_state, server_pair, settle_both, settled, wait_until)

torch.set_num_threads(1)

NOW = 1_700_000_000.0


def both_stores(monkeypatch):
    """A reference store and a port store that took the same writes (the
    port's of the carried structs), the clock pinned so the write times
    agree: nodes, a node pool, jobs with and without a scaling block and
    a second version, evals, allocs (one client-terminal, one stopped by
    the server and still running), a scaling event."""
    monkeypatch.setattr(time, "time", lambda: NOW)
    ref_reseed_ids(21)
    mock._counter = itertools.count()
    ref, port = RefStateStore(), StateStore()
    memo = {}

    def write(method, *args):
        getattr(ref, method)(*args)
        getattr(port, method)(*[struct_from_reference(a, memo)
                                if not isinstance(a, str) else a
                                for a in args])

    write("set_scheduler_config", SchedulerConfiguration(
        scheduler_algorithm="tpu-binpack"))
    nodes = [mock.node() for _ in range(4)]
    for n in nodes:
        write("upsert_node", n)
    write("upsert_node_pool", NodePool(name="cheap"))
    scaly = mock.job(id="scaly")
    scaly.task_groups[0].scaling = {"min": 1, "max": 9,
                                    "policy": {"cooldown": "1m"}}
    plain = mock.job(id="plain")
    for j in (scaly, plain):
        write("upsert_job", j)
    scaly2 = copy.deepcopy(scaly)
    scaly2.task_groups[0].count = 3
    write("upsert_job", scaly2)
    ev = mock.evaluation(job_id="scaly")
    write("upsert_evals", [ev])
    allocs = [mock.alloc_for(scaly2, nodes[k % 4], k) for k in range(3)]
    allocs.append(mock.alloc_for(plain, nodes[0], 0))
    allocs[1].client_status = "complete"
    allocs[2].desired_status = "stop"
    allocs[2].client_status = "running"
    write("upsert_allocs", allocs)
    write("upsert_scaling_event", "default", "scaly", ScalingEvent(
        time=NOW, task_group="web", count=3, previous_count=10,
        message="down", eval_id=ev.id))
    return ref, port


def test_dump_state_equals_the_reference_table_by_table(monkeypatch):
    ref, port = both_stores(monkeypatch)
    got, want = dump_state(port), ref_dump_state(ref)
    assert got["index"] == want["index"]
    assert got["table_index"] == {t: want["table_index"][t] for t in TABLES}
    for key in got:
        if key != "table_index":
            assert got[key] == want[key], key
    assert got["scaling_policies"] and got["scaling_events"]
    # the blob is JSON, and a dump of a restore is the same blob
    blob = json.loads(json.dumps(got))
    again = StateStore()
    restore_state(again, blob)
    assert dump_state(again) == got


def test_dump_state_encodes_outside_the_store_lock(monkeypatch):
    """dump_state holds the store's lock only while it copies the
    tables: a write made from another thread while the dump encodes
    goes through at once, and the blob is the tables as they stood
    before it (the node it adds is not in the dump)."""
    from nomad_tpu_torch.state import restore as port_restore

    _, port = both_stores(monkeypatch)
    before = {n["id"] for n in dump_state(port)["nodes"]}
    extra = pmock.node()
    encode = port_restore.codec.encode
    wrote = []

    def encode_with_a_write(obj):
        if not wrote:
            t = threading.Thread(target=lambda: wrote.append(
                port.upsert_node(extra)))
            t.start()
            t.join(timeout=10.0)
            assert wrote, "the write waited for the dump's encoding"
        return encode(obj)
    monkeypatch.setattr(port_restore.codec, "encode", encode_with_a_write)
    blob = dump_state(port)
    monkeypatch.setattr(port_restore.codec, "encode", encode)
    assert {n["id"] for n in blob["nodes"]} == before
    assert port.node_by_id(extra.id) is not None
    assert blob["index"] < port.latest_index()


@pytest.mark.parametrize("source", ["reference", "port"])
def test_each_package_restores_the_others_blob(monkeypatch, source):
    ref, port = both_stores(monkeypatch)
    blob = json.loads(json.dumps(
        ref_dump_state(ref) if source == "reference" else dump_state(port)))
    pfresh, rfresh = StateStore(), RefStateStore()
    restore_state(pfresh, blob)
    ref_restore_state(rfresh, blob)
    got, want = dump_state(pfresh), ref_dump_state(rfresh)
    for key in got:
        if key != "table_index":
            assert got[key] == want[key], key
    # secondary indexes, the alloc table and the job links
    assert [a.id for a in pfresh.allocs_by_job("default", "scaly")] == \
        [a.id for a in rfresh.allocs_by_job("default", "scaly")]
    for a in pfresh.allocs():
        assert a.job is pfresh.job_by_id(a.namespace, a.job_id)
    with pfresh._lock:
        assert pfresh.alloc_table.fold_parity_mismatch() == 0
    client_terminal = [a.id for a in pfresh.allocs()
                       if a.client_terminal_status()]
    assert len(client_terminal) == 1
    assert pfresh.alloc_table.n_rows == len(pfresh.allocs()) - 1
    assert pfresh.scaling_policies_by_job("default", "scaly")
    assert [e.message for e in
            pfresh.scaling_events_by_job("default", "scaly")] == ["down"]


def test_restore_decodes_everything_before_it_writes(monkeypatch):
    ref, port = both_stores(monkeypatch)
    before = dump_state(port)
    blob = copy.deepcopy(before)
    blob["job_versions"] = {"no-separators-here": {}}
    with pytest.raises(ValueError):
        restore_state(port, blob)
    with pytest.raises(ValueError):
        port.restore_from_snapshot(blob)
    assert dump_state(port) == before


def test_restore_from_snapshot_keeps_the_index_and_breaks_the_journal(
        monkeypatch):
    """The index becomes max(restored, prior) and every table is
    bumped past it, in both packages; a span of the alloc-delta journal
    across the restore is not coverable."""
    ref, port = both_stores(monkeypatch)
    blob = json.loads(json.dumps(dump_state(port)))
    for _ in range(3):
        port.upsert_evals([pst.Evaluation(id=pst.generate_uuid())])
        ref.upsert_evals([Evaluation(id=pst.generate_uuid())])
    prior = port.latest_index()
    allocs_before = port.table_index("allocs")
    idx = port.restore_from_snapshot(blob)
    ridx = ref.restore_from_snapshot(blob)
    assert idx == ridx == prior + 1 == port.latest_index()
    assert all(port.table_index(t) == idx for t in TABLES)
    covered, _ = port.alloc_deltas_since(allocs_before)
    assert not covered
    assert port.alloc_deltas_since(idx) == (True, [])


def test_reference_blob_restored_in_the_port_places_the_next_job_alike():
    """A reference server places two jobs; its dump, through JSON,
    restored into a fresh port store under a port Server; one more job
    registered in both (ids seeded alike): equal placements and scores,
    node for node."""
    ref_reseed_ids(4)
    mock._counter = itertools.count()
    store = RefStateStore()
    store.set_scheduler_config(SchedulerConfiguration(
        scheduler_algorithm="tpu-binpack"))
    for _ in range(6):
        store.upsert_node(mock.node())
    with server_pair(store) as (ref, carried, _):
        for k, count in enumerate((5, 4)):
            j = mock.job(id=f"before-{k}")
            j.task_groups[0].count = count
            ref_reseed_ids(30 + k)
            ev = ref.register_job(j)
            wait_until(lambda: settled(ref, [ev.id]), msg="ref placed")
        blob = json.loads(json.dumps(ref_dump_state(store)))
    fresh = StateStore()
    restore_state(fresh, blob)
    assert fresh.latest_index() == store.latest_index()
    port = Server(state=fresh, device="cpu", num_workers=2,
                  heartbeat_ttl=3600.0)
    ref = RefServer(state=store, num_workers=2, heartbeat_ttl=3600.0)
    ref.start()
    port.start()
    try:
        j = mock.job(id="after")
        j.task_groups[0].count = 6
        ref_reseed_ids(40)
        ev = ref.register_job(copy.deepcopy(j))
        pst.reseed_ids(40)
        pev = port.register_job(struct_from_reference(j))
        assert ev.id == pev.id
        settle_both(ref, port, [ev.id])
        assert_same(ref, port)
        assert len([a for a in port.state.allocs()
                    if a.job_id == "after"]) == 6
    finally:
        ref.shutdown()
        port.shutdown()


# --------------------------------------------------------------------------
# archives (tests/test_snapshot_events.py:25-44)

def test_archive_round_trip_in_both_directions():
    blob = {"index": 42, "jobs": [{"id": "x"}]}
    for save, load in ((save_archive, load_archive),
                       (save_archive, ref_load_archive),
                       (ref_save_archive, load_archive)):
        meta, restored = load(save(blob, 42))
        assert restored == blob and meta["index"] == 42
        assert meta["format_version"] == 1


def test_archive_corruption_and_garbage_are_refused():
    framed = bytearray(gzip.decompress(save_archive({"index": 1}, 1)))
    framed[-3] ^= 0xFF                      # a payload byte flipped
    with pytest.raises(ValueError, match="checksum"):
        load_archive(gzip.compress(bytes(framed)))
    for junk in (b"not an archive", gzip.compress(b"no newline"),
                 gzip.compress(b'{"meta": 3}\n{}'),
                 gzip.compress(b'{"meta": {"format_version": 2}}\n{}')):
        with pytest.raises(ValueError):
            load_archive(junk)


# --------------------------------------------------------------------------
# the server's save and restore (tests/test_snapshot_events.py:46-96, 256)

def _server(**kw):
    s = Server(device="cpu", num_workers=1, heartbeat_ttl=3600.0, **kw)
    s.start()
    return s


def test_snapshot_save_restore_round_trip_into_a_fresh_server():
    server = _server()
    other = None
    try:
        server.register_job(_plain_job("snapjob"))
        node = _node()
        server.register_node(node)
        data = server.snapshot_save()
        other = _server()
        meta = other.snapshot_restore(data)
        assert 0 < meta["index"] <= server.state.latest_index()
        assert other.state.job_by_id("default", "snapjob") is not None
        assert other.state.node_by_id(node.id) is not None
        assert other.is_leader()
        topics = [e["topic"] for e in other.events_since(0)]
        assert "SnapshotRestored" in topics
    finally:
        server.shutdown()
        if other is not None:
            other.shutdown()


def _plain_job(job_id):
    return pmock.job(id=job_id)


def _node():
    return pmock.node()


def test_snapshot_restore_reenqueues_pending_evals():
    """A pending eval in the archive reaches the new leader's broker in
    one burst and is processed (no nodes: it blocks or completes)."""
    server = _server()
    other = None
    try:
        server.register_job(_plain_job("j1"))
        ev = pst.Evaluation(id=pst.generate_uuid(), namespace="default",
                            priority=50, type="service", job_id="j1",
                            status=EVAL_STATUS_PENDING, triggered_by="test")
        server.state.upsert_evals([ev])
        data = server.snapshot_save()
        other = _server()
        seen = []
        real = other.broker.enqueue_all
        other.broker.enqueue_all = lambda evs: (seen.append(
            [e.id for e in evs]), real(evs))[1]
        other.snapshot_restore(data)
        assert any(ev.id in burst for burst in seen), seen

        def done():
            stored = other.state.eval_by_id(ev.id)
            return (stored is not None and stored.status != "pending") \
                or other.blocked_evals.stats()["total_blocked"]
        wait_until(done, msg="the restored eval processed")
    finally:
        server.shutdown()
        if other is not None:
            other.shutdown()


def test_snapshot_restore_refuses_garbage_and_malformed_blobs():
    """Garbage is refused before anything changes; a checksum-valid
    archive whose blob does not decode raises and leaves the store as
    it was. The reference stays without leadership after that failed
    restore (its workers stopped); the port establishes it again."""
    server = _server()
    ref = RefServer(num_workers=1, heartbeat_ttl=3600.0)
    ref.start()
    try:
        for s, ev in ((server, server.register_job(_plain_job("survivor"))),
                      (ref, ref.register_job(mock.job(id="survivor")))):
            # no nodes: the eval blocks; wait for its blocked follow-up
            wait_until(lambda s=s, e=ev: settled(s, [e.id])
                       and s.blocked_evals.stats()["total_blocked"],
                       msg="the survivor's eval blocked")
        with pytest.raises(ValueError):
            server.snapshot_restore(b"garbage")
        before = dump_state(server.state)
        for s, dump in ((server, dump_state), (ref, ref_dump_state)):
            blob = dump(s.state)
            blob["job_versions"] = {"no-separators-here": {}}
            with pytest.raises(ValueError):
                s.snapshot_restore(save_archive(blob, blob["index"]))
            assert s.state.job_by_id("default", "survivor") is not None
        assert dump_state(server.state) == before
        assert server.is_leader() and server.workers
        assert not ref.is_leader()
    finally:
        server.shutdown()
        ref.shutdown()
        # the reference's shutdown leaves its commit thread to end alone
        for t in threading.enumerate():
            if t.name.startswith("plan-commit"):
                t.join(timeout=10.0)


# --------------------------------------------------------------------------
# the caches across a restore

def _cache_world():
    ref_reseed_ids(6)
    mock._counter = itertools.count()
    store = RefStateStore()
    store.set_scheduler_config(SchedulerConfiguration(
        scheduler_algorithm="tpu-binpack"))
    for _ in range(6):
        store.upsert_node(mock.node())
    return store


def test_restore_over_another_history_places_as_a_fresh_restore():
    """Servers A and B start from one world; A places one job, B another
    (a different ask), and B pads its index to A's. A's archive is
    restored into B, which holds A's index, a node matrix, a usage memo
    and a journal of its own history; a fresh server F restores it too.
    One job registered in B and F (ids seeded alike) is placed the same,
    node for node: nothing of B's history served B's pack."""
    store = _cache_world()
    kw = dict(device="cpu", num_workers=2, heartbeat_ttl=3600.0)
    a = Server(state=store_from_reference(store.snapshot()), **kw)
    b = Server(state=store_from_reference(store.snapshot()), **kw)
    f = Server(**kw)
    try:
        for s in (a, b, f):
            s.start()
        for s, count, cpu, seed in ((a, 5, 500, 50), (b, 9, 1500, 51)):
            j = _plain_job(f"hist-{seed}")
            j.task_groups[0].count = count
            j.task_groups[0].tasks[0].resources.cpu = cpu
            pst.reseed_ids(seed)
            ev = s.register_job(j)
            wait_until(lambda s=s, e=ev: settled(s, [e.id]), msg="history")
        while b.state.latest_index() < a.state.latest_index():
            b.state.upsert_evals([])
        assert b.state.latest_index() == a.state.latest_index()
        data = a.snapshot_save()
        b.snapshot_restore(data)
        f.snapshot_restore(data)
        assert b.state.latest_index() == f.state.latest_index()
        assert dump_state(b.state)["allocs"] == dump_state(f.state)["allocs"]
        ids = []
        for s in (b, f):
            j = _plain_job("after")
            j.task_groups[0].count = 7
            pst.reseed_ids(60)
            ev = s.register_job(j)
            ids.append(ev.id)
            wait_until(lambda s=s, e=ev: settled(s, [e.id]), msg="after")
        assert ids[0] == ids[1]
        assert_same(f, b)
        assert len([x for x in b.state.allocs() if x.job_id == "after"]) \
            == 7
        with b.state._lock:
            assert b.state.alloc_table.fold_parity_mismatch() == 0
    finally:
        for s in (a, b, f):
            s.shutdown()


def test_state_copy_ab_runs_both_codecs(capsys):
    """state_copy_ab.py, the measurement of the state copy under two
    codecs, on a small state: every run of each side restores the blob
    and dumps it back equal (a run whose dump differs fails), and the
    report counts each side's runs and the pairs the second side won."""
    import state_copy_ab

    codec = str(Path(state_copy_ab.__file__).parent / "nomad_tpu_torch"
                / "structs" / "codec.py")
    assert state_copy_ab.main(["--nodes", "6", "--jobs", "2", "--allocs",
                               "9", "--pairs", "2", f"a={codec}",
                               f"b={codec}"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["allocs"] == 9
    assert [len(report["runs"][t]) for t in ("a", "b")] == [2, 2]
    for key in ("restore_ms", "dump_ms"):
        assert 0 <= report[key]["b_wins"] <= 2
        assert report[key]["a"]["median"] > 0
