"""The port's cluster tables (namespaces and node pools: the store's
writes, deletes and listings, the Server's operations, node-pool
admission of jobs) held against the JAX package's on the CPU. Both
Servers are built on one world (the port's store carried from the
reference's) and are not started: the operations are host logic, so
every comparison is exact: the outcome (or the error's text), the
events, the index and each table's index, and the tables themselves.
"""
import dataclasses
import itertools
import time

import pytest

from nomad_tpu import mock
from nomad_tpu.raft.fsm import dump_state as ref_dump
from nomad_tpu.server import Server as RefServer
from nomad_tpu.state import StateStore as RefStateStore
from nomad_tpu.structs import Namespace as RefNamespace
from nomad_tpu.structs import NamespaceNodePoolConfiguration as RefNpc
from nomad_tpu.structs import NodePool as RefNodePool
from nomad_tpu.structs.job import reseed_ids as ref_reseed_ids

from nomad_tpu_torch import structs as pst
from nomad_tpu_torch.carry import store_from_reference, struct_from_reference
from nomad_tpu_torch.server import Server
from nomad_tpu_torch.state.restore import dump_state
from nomad_tpu_torch.state.store import StateStore

NOW = 1_700_000_000.0


@pytest.fixture
def pair(monkeypatch):
    """(reference Server, port Server) on one world of 4 nodes, two of
    them in node pool "pool-a"; the clock pinned."""
    monkeypatch.setattr(time, "time", lambda: NOW)
    ref_reseed_ids(5)
    mock._counter = itertools.count()
    store = RefStateStore()
    for k in range(4):
        n = mock.node()
        if k < 2:
            n.node_pool = "pool-a"
        store.upsert_node(n)
    store.upsert_node_pool(RefNodePool(name="pool-a"))
    store.upsert_node_pool(RefNodePool(name="pool-b"))
    ref = RefServer(state=store)
    port = Server(state=store_from_reference(store.snapshot()),
                  device="cpu")
    assert port.state.latest_index() == store.latest_index()
    return ref, port


def run_both(ref, port, op, *args, seed=None):
    """One operation on each Server (the port's arguments carried);
    their outcomes: ("ok", result) or ("error", type, text)."""
    out = []
    memo = {}
    for srv, reseed, carry in ((ref, ref_reseed_ids, lambda a: a),
                               (port, pst.reseed_ids,
                                lambda a: struct_from_reference(a, memo))):
        if seed is not None:
            reseed(seed)
        try:
            res = getattr(srv, op)(*[carry(a) for a in args])
            out.append(("ok", None if res is None else type(res).__name__))
        except Exception as e:  # noqa: BLE001 -- compared by text
            out.append(("error", type(e).__name__, str(e)))
    return out[1], out[0]


def tables(srv):
    st = srv.state
    return {
        "index": st.latest_index(),
        # (the carry puts the untouched job table at the world's index)
        "table_index": {t: st.table_index(t)
                        for t in ("namespaces", "node_pools")},
        "namespaces": [dataclasses.asdict(n) for n in st.namespaces()],
        "node_pools": [dataclasses.asdict(p) for p in st.node_pools()],
        "events": [{k: v for k, v in e.items() if k != "time"}
                   for e in srv.events_since(0)],
    }


def same(ref, port, op, *args, seed=None):
    got, want = run_both(ref, port, op, *args, seed=seed)
    assert got == want, (op, got, want)
    assert tables(port) == tables(ref), op
    return got


def test_namespace_operations_equal_the_reference(pair):
    ref, port = pair
    team = RefNamespace(name="team-a", description="a team",
                        meta={"owner": "a"},
                        node_pool_configuration=RefNpc(default="pool-a"))
    assert same(ref, port, "upsert_namespace", team) == ("ok", None)
    for bad in ("", "a/b"):
        assert same(ref, port, "upsert_namespace",
                    RefNamespace(name=bad))[0] == "error"
    # an update keeps the create index
    same(ref, port, "upsert_namespace",
         RefNamespace(name="team-a", description="again"))
    assert same(ref, port, "delete_namespace", "default")[0] == "error"
    assert same(ref, port, "delete_namespace", "nope")[0] == "error"
    job = mock.job(id="in-team")
    job.namespace = "team-a"
    same(ref, port, "register_job", job, seed=7)
    got = same(ref, port, "delete_namespace", "team-a")
    assert got[2] == "namespace 'team-a' has 1 non-purged jobs", got
    same(ref, port, "deregister_job", "team-a", "in-team", True, seed=8)
    assert same(ref, port, "delete_namespace", "team-a") == ("ok", None)
    assert [n.name for n in port.state.namespaces()] == ["default"]


def test_node_pool_operations_equal_the_reference(pair):
    ref, port = pair
    for bad in ("", "all"):
        got = same(ref, port, "upsert_node_pool", RefNodePool(name=bad))
        assert got[0] == "error", got
    same(ref, port, "upsert_node_pool",
         RefNodePool(name="pool-c", description="c",
                     scheduler_algorithm="spread"))
    same(ref, port, "upsert_node_pool",
         RefNodePool(name="pool-c", description="c again"))
    for name in ("default", "all", "nope"):
        assert same(ref, port, "delete_node_pool", name)[0] == "error"
    got = same(ref, port, "delete_node_pool", "pool-a")
    assert got[2] == "node pool 'pool-a' has 2 nodes", got
    job = mock.job(id="in-b")
    job.node_pool = "pool-b"
    same(ref, port, "register_job", job, seed=9)
    got = same(ref, port, "delete_node_pool", "pool-b")
    assert got[2] == "node pool 'pool-b' used by 1 jobs", got
    assert same(ref, port, "delete_node_pool", "pool-c") == ("ok", None)
    assert [p.name for p in port.state.node_pools()] == \
        ["all", "default", "pool-a", "pool-b"]


# (namespace node-pool configuration, the job's pool) -> admission
ADMISSION = [
    ({"default": "pool-a"}, ""),
    ({"default": "pool-a"}, "default"),
    ({"default": "pool-a"}, "pool-b"),
    ({"default": "pool-a", "denied": ["pool-a"]}, ""),
    ({"allowed": ["pool-a"]}, "pool-b"),
    ({"allowed": ["pool-a"]}, "pool-a"),
    ({"denied": ["pool-b"]}, "pool-b"),
    ({"denied": ["pool-b"]}, "default"),
    ({}, "all"),
    ({}, "nope"),
    ({"default": "nope"}, ""),
    ({"default": "all"}, "default"),
]


@pytest.mark.parametrize("k", range(len(ADMISSION)))
def test_node_pool_admission_equals_the_reference(pair, k):
    ref, port = pair
    npc, pool = ADMISSION[k]
    same(ref, port, "upsert_namespace", RefNamespace(
        name="team-a", node_pool_configuration=RefNpc(**npc)))
    job = mock.job(id="adm")
    job.namespace = "team-a"
    job.node_pool = pool
    got = same(ref, port, "register_job", job, seed=11)
    stored = [(j.namespace, j.id, j.node_pool) for j in port.state.jobs()]
    assert stored == [(j.namespace, j.id, j.node_pool)
                      for j in ref.state.jobs()]
    if got[0] == "ok":
        assert stored[0][2] not in ("", "all")
    # a job in a namespace that does not exist
    job = mock.job(id="lost")
    job.namespace = "nowhere"
    got = same(ref, port, "register_job", job, seed=12)
    assert got[2] == "namespace 'nowhere' does not exist", got


def test_store_writes_equal_the_reference():
    """The store's own writes: the built-ins stay without a write, every
    other write is one index, and the dumps agree."""
    ref, port = RefStateStore(), StateStore()
    for store, ns_cls, pool_cls in (
            (ref, RefNamespace, RefNodePool),
            (port, pst.Namespace, pst.NodePool)):
        store.upsert_namespace(ns_cls(name="x"))
        store.upsert_namespace(ns_cls(name="x", description="y"))
        store.delete_namespace("default")
        store.delete_namespace("nope")
        store.upsert_node_pool(pool_cls(name="p"))
        store.delete_node_pool("all")
        store.delete_node_pool("default")
        store.delete_node_pool("p")
    assert port.latest_index() == ref.latest_index() == 6
    for t in ("namespaces", "node_pools"):
        assert port.table_index(t) == ref.table_index(t)
    got, want = dump_state(port), ref_dump(ref)
    for key in ("namespaces", "node_pools", "index"):
        assert got[key] == want[key], key
    assert port.variables("x") == ref.variables("x") == []
