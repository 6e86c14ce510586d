"""The port's search (nomad_tpu_torch/server/search.py Searcher, the
Server's search / fuzzy_search) held against the JAX package's on the
CPU, on a store carried from the reference's: prefix and fuzzy search
in every context and in "all", in one namespace, in "*" and with no
namespace, filtered by an ACL's namespaces and by allowed contexts,
with more than 20 matches (the truncation) in some contexts. Exact.
"""
import itertools
import time

import pytest

from nomad_tpu import mock
from nomad_tpu.server import Server as RefServer
from nomad_tpu.server.search import ALL_CONTEXTS as REF_CONTEXTS
from nomad_tpu.server.search import Searcher as RefSearcher
from nomad_tpu.state import StateStore as RefStateStore
from nomad_tpu.structs import Deployment, Namespace, NodePool
from nomad_tpu.structs.job import reseed_ids as ref_reseed_ids

from nomad_tpu_torch.carry import store_from_reference
from nomad_tpu_torch.server import Server
from nomad_tpu_torch.server import search as port_search
from nomad_tpu_torch.server.search import Searcher

NOW = 1_700_000_000.0


@pytest.fixture(scope="module")
def world():
    """A reference store: 30 nodes (ids and names), namespaces default,
    team-a and team-b, node pools, 26 jobs (24 "web-*" in default, two
    in team-a, one with a scaling block), evals, allocs and deployments;
    and the port's store carried from it."""
    real_time = time.time
    time.time = lambda: NOW
    try:
        ref_reseed_ids(17)
        mock._counter = itertools.count()
        store = RefStateStore()
        nodes = []
        for k in range(30):
            n = mock.node(name=f"host-{k:02d}")
            if k % 3 == 0:
                n.node_pool = "pool-a"
            nodes.append(n)
            store.upsert_node(n)
        for name in ("pool-a", "pool-ab", "batch-pool"):
            store.upsert_node_pool(NodePool(name=name))
        for name in ("team-a", "team-b", "tools"):
            store.upsert_namespace(Namespace(name=name))
        jobs = []
        for k in range(24):
            j = mock.job(id=f"web-{k:02d}", name=f"web-{k:02d}")
            j.task_groups[0].name = f"web-group-{k % 3}"
            jobs.append(j)
        for k, ns in enumerate(("team-a", "team-a", "team-b")):
            j = mock.job(id=f"api-{k}", name=f"API-service-{k}")
            j.namespace = ns
            j.task_groups[0].scaling = {"min": 1, "max": 5}
            j.task_groups[0].tasks[0].name = "webserver"
            jobs.append(j)
        for j in jobs:
            store.upsert_job(j)
        evals, allocs, deps = [], [], []
        for k, j in enumerate(jobs):
            evals.append(mock.evaluation(job_id=j.id, namespace=j.namespace))
            for i in range(2):
                allocs.append(mock.alloc_for(j, nodes[(k + i) % 30], i))
            deps.append(Deployment(id=evals[-1].id[::-1], job_id=j.id,
                                   namespace=j.namespace))
        store.upsert_evals(evals)
        store.upsert_allocs(allocs)
        for d in deps:
            store.upsert_deployment(d)
    finally:
        time.time = real_time
    return store, store_from_reference(store.snapshot()), evals, allocs


def _terms(evals, allocs):
    return ["", "w", "web-", "web-1", "web-group", "host-1", "host-0",
            "API", "api", "pool", "team", "server", "t",
            evals[0].id[:1], evals[3].id[:6], allocs[5].id[:2],
            evals[0].id[::-1][:3], "zz"]


ALLOWED = {"open": None,
           "team-a": lambda ns: ns == "team-a",
           "default": lambda ns: ns == "default",
           "nothing": lambda ns: False}
NAMESPACES = [None, "default", "team-a", "*", "nope"]
CONTEXTS = ["all"] + list(port_search.ALL_CONTEXTS)


def test_contexts_equal_the_reference():
    assert port_search.ALL_CONTEXTS == REF_CONTEXTS
    assert port_search.TRUNCATE_LIMIT == 20


@pytest.mark.parametrize("context", CONTEXTS)
@pytest.mark.parametrize("mode", ["prefix", "fuzzy"])
def test_search_equals_the_reference(world, context, mode):
    ref, port, evals, allocs = world
    n_hits = 0
    for term, ns, (aname, allow) in itertools.product(
            _terms(evals, allocs), NAMESPACES, ALLOWED.items()):
        got = getattr(Searcher(port, allow), f"{mode}_search")(
            term, context, ns)
        want = getattr(RefSearcher(ref, allow), f"{mode}_search")(
            term, context, ns)
        assert got == want, (term, ns, aname)
        n_hits += sum(len(v) for v in got["matches"].values())
    # (no CSI or variables table in either world: those find nothing)
    assert n_hits or context in ("variables", "plugins", "volumes")


def test_truncation_and_allowed_contexts(world):
    ref, port, _, _ = world
    for mode, term in (("prefix", "web-"), ("fuzzy", "web"),
                       ("fuzzy", "host"), ("prefix", "")):
        got = getattr(Searcher(port), f"{mode}_search")(term)
        want = getattr(RefSearcher(ref), f"{mode}_search")(term)
        assert got == want
        assert got["truncations"], (mode, term)
        assert all(len(v) <= 20 for v in got["matches"].values())
    for allowed in ([], ["jobs"], ["nodes", "node_pools", "namespaces"],
                    ["scaling_policy", "variables", "plugins"]):
        for mode in ("prefix", "fuzzy"):
            got = getattr(Searcher(port), f"{mode}_search")(
                "", "all", "*", allowed)
            want = getattr(RefSearcher(ref), f"{mode}_search")(
                "", "all", "*", allowed)
            assert got == want
            assert set(got["matches"]) <= set(allowed) | {"groups",
                                                          "tasks"}


def test_server_search_equals_the_reference(world):
    ref_store, port_store, _, _ = world
    ref, port = RefServer(state=ref_store), Server(state=port_store,
                                                   device="cpu")
    for args in (("web-1",), ("api", "jobs", "team-a"),
                 ("", "namespaces", "*", None, lambda ns: ns != "team-b")):
        assert port.search(*args) == ref.search(*args)
        assert port.fuzzy_search(*args) == ref.fuzzy_search(*args)
