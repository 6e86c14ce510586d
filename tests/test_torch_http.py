"""The port's HTTP API (nomad_tpu_torch/api/http.py) and its client
(api/client.py) held against the JAX package's on the CPU.

Two agents on one world: a reference HttpServer over a reference Server
(its store built with the reference's mock, node ids seeded) and a port
HttpServer over a port Server (device="cpu") on the carried store, at
the same index. The same requests go to both, and the JSON replies are
compared after normalizing: ids minted by worker threads (allocs,
deployments, follow-up evals) become names derived from what they
name, wall times become 0, and float64 scores compare at rtol 1e-12;
everything else is exact. Each request thread of both agents carries
one name (the port's handler names it; the reference's is given the
same name here), so with both id streams reseeded alike a registration
mints the same eval id in both, and the node shuffle it seeds is the
same. Jobs go in one at a time and each settles before the next.

Also: placements made through HTTP (a JSON job, an HCL job, and a
paused burst of evals released in one batch) equal a port Server's fed
the same Job structs in process from request-named threads; a blocking
query on /v1/node/<id>/allocations; a node agent's round trip through
HttpServerConn; guard reprobe, fault arming, the quarantine, the
Prometheus text's names for the deterministic counters, /v1/agent/self's
blocks, and the 404 of a route the port does not serve (the profiler
endpoint: tests/test_torch_agent.py). The job operations through both
agents (plans of JSON and HCL jobs, a refused plan, an ask no node holds,
the scaling policies, scale within and outside the bounds and its
status, a dispatch with a base64 payload, its idempotency token and its
refusals; both clocks pinned to one second, which a child's id reads),
and the operator snapshot routes (save, restore, junk refused, each
package's archive restored by the other's agent). Every wait has a
deadline; every server is shut down.
"""
import contextlib
import itertools
import json
import math
import re
import threading
import urllib.request

import pytest
import torch

from nomad_tpu import mock
from nomad_tpu.api import http as ref_http
from nomad_tpu.api.client import ApiClient as RefApiClient
from nomad_tpu.api.client import HttpServerConn as RefServerConn
from nomad_tpu.faultinject import faults as ref_faults
from nomad_tpu.server import Server as RefServer
from nomad_tpu.state import StateStore as RefStateStore
from nomad_tpu.structs import SchedulerConfiguration
from nomad_tpu.structs.job import reseed_ids as ref_reseed_ids

from nomad_tpu_torch import mock as pmock
from nomad_tpu_torch import structs as pst
from nomad_tpu_torch.api import http as port_http
from nomad_tpu_torch.api.client import ApiClient, HttpServerConn
from nomad_tpu_torch.carry import store_from_reference, struct_from_reference
from nomad_tpu_torch.faultinject import faults
from nomad_tpu_torch.server import Server
from nomad_tpu_torch.solver import guard
from nomad_tpu.solver import guard as ref_guard

from test_jobspec_cli import MINI_SPEC
from test_torch_server import (  # noqa: F401 -- fresh_state is autouse
    InOrderLanes, assert_same, fresh_state, settled, wait_until)
from test_torch_telemetry import deterministic, reset_globals

torch.set_num_threads(1)

N_NODES = 6
WIDTH = 4
TIME_KEYS = ("time", "timestamp", "_at", "age_s", "wait_until",
             "modify_time", "create_time")


@pytest.fixture(autouse=True)
def fresh_telemetry():
    reset_globals()
    yield
    reset_globals()


def _named_request(handle):
    def run(self):
        threading.current_thread().name = "http-request"
        return handle(self)
    return run


def ref_world(seed=3, n=N_NODES):
    ref_reseed_ids(seed)
    mock._counter = itertools.count()
    store = RefStateStore()
    store.set_scheduler_config(SchedulerConfiguration(
        scheduler_algorithm="tpu-binpack"))
    for _ in range(n):
        store.upsert_node(mock.node())
    return store


@contextlib.contextmanager
def agents(monkeypatch, store=None, width=WIDTH, order=None):
    """(ref, port): each a (Server, ApiClient) pair behind its own
    HttpServer, on one world at one index; shut down on exit."""
    monkeypatch.setattr(ref_http.ApiHandler, "handle",
                        _named_request(ref_http.ApiHandler.handle))
    store = store if store is not None else ref_world()
    kw = dict(num_workers=2, eval_batching=True, batch_width=width,
              heartbeat_ttl=3600.0)
    ref = RefServer(state=store, **kw)
    port = rhttp = phttp = None
    try:
        if order is not None:
            order.attach(ref)
        ref.start()
        port = Server(state=store_from_reference(store.snapshot()),
                      device="cpu", **kw)
        if order is not None:
            order.attach(port)
        port.start()
        assert port.state.latest_index() == store.latest_index()
        rhttp = ref_http.HttpServer(ref, port=0)
        rhttp.start()
        phttp = port_http.HttpServer(port, port=0)
        phttp.start()
        yield ((ref, RefApiClient(f"http://127.0.0.1:{rhttp.port}")),
               (port, ApiClient(f"http://127.0.0.1:{phttp.port}")))
    finally:
        for h in (rhttp, phttp):
            if h is not None:
                h.shutdown()
        ref.shutdown()
        if port is not None:
            port.shutdown()


def id_names(server):
    """Every id a worker thread minted -> a name from what it names."""
    names = {}
    for a in server.state.allocs():
        names[a.id] = f"alloc:{a.name}:{a.create_index}"
    for d in server.state.deployments():
        names[d.id] = f"deployment:{d.job_id}:{d.job_version}"
    evs = sorted(server.state.evals(),
                 key=lambda e: (e.job_id, e.create_index, e.triggered_by))
    for k, e in enumerate(evs):
        names.setdefault(e.id, f"eval:{e.job_id}:{e.triggered_by}:{k}")
    return names


def norm(x, names):
    if isinstance(x, dict):
        return {k: (0 if any(t in k for t in TIME_KEYS) and
                    isinstance(v, (int, float)) else norm(v, names))
                for k, v in x.items()}
    if isinstance(x, list):
        out = [norm(v, names) for v in x]
        if out and all(isinstance(v, dict) for v in out):
            out.sort(key=lambda d: json.dumps(d, sort_keys=True))
        return out
    if isinstance(x, str):
        if x in names:
            return names[x]
        if "." in x and x.split(".", 1)[0] in names:
            head, tail = x.split(".", 1)
            return f"{names[head]}.{tail}"
        return x
    return x


def same(got, want, path="$"):
    """Equal, floats at rtol 1e-12."""
    if isinstance(want, float) and isinstance(got, (int, float)):
        assert math.isclose(got, want, rel_tol=1e-12, abs_tol=0.0) or \
            (math.isnan(got) and math.isnan(want)), (path, got, want)
        return
    assert type(got) is type(want), (path, got, want)
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), (path, sorted(got),
                                             sorted(want))
        for k in want:
            same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), (path, len(got), len(want))
        for i, (g, w) in enumerate(zip(got, want)):
            same(g, w, f"{path}[{i}]")
    else:
        assert got == want, (path, got, want)


def ask(pair, method, path, body=None, **params):
    """(status, JSON reply) of one request; errors answer too."""
    server, api = pair
    try:
        if method == "GET":
            return 200, api.get(path, **params)
        if method == "DELETE":
            return 200, api.delete(path, **params)
        return 200, api.post(path, body, **params)
    except Exception as e:  # noqa: BLE001 -- both clients' ApiError
        return e.status, str(e)


def both(ref, port, method, path, body=None, **params):
    """The same request to both agents; their normalized replies."""
    r = ask(ref, method, path, body, **params)
    p = ask(port, method, path, body, **params)
    return (p[0], norm(p[1], id_names(port[0]))), \
        (r[0], norm(r[1], id_names(ref[0])))


def check(ref, port, method, path, body=None, **params):
    got, want = both(ref, port, method, path, body, **params)
    same(got, want)
    return got


def register_both(ref, port, body, seed):
    """Register through both APIs, ids seeded alike; wait until both
    settle. Returns the eval id (the same in both)."""
    out = []
    for pair, reseed in ((ref, ref_reseed_ids), (port, pst.reseed_ids)):
        reseed(seed)
        status, reply = ask(pair, "POST", "/v1/jobs", body)
        assert status == 200, reply
        eid = reply["eval_id"]
        wait_until(lambda s=pair[0], e=eid: settled(s, [e]),
                   msg="registered")
        out.append(reply)
    assert out[0] == out[1]
    return out[0]["eval_id"]


def json_job(job_id, count=3, cpu=500):
    j = mock.job(id=job_id)
    j.task_groups[0].count = count
    j.task_groups[0].tasks[0].resources.cpu = cpu
    return ref_http.to_jsonable(j)


# --------------------------------------------------------------------------

def test_route_table_replies_equal_the_reference(monkeypatch):
    with agents(monkeypatch) as (ref, port):
        for path in ("/v1/agent/health", "/v1/status/leader",
                     "/v1/nodes", "/v1/operator/scheduler/configuration"):
            check(ref, port, "GET", path)
        eid = register_both(ref, port, {"job": json_job("web-a")}, 11)
        register_both(ref, port, {"job": json_job("web-b", count=2)}, 12)
        register_both(ref, port, {"job_hcl": MINI_SPEC}, 13)
        check(ref, port, "POST", "/v1/jobs/parse", {"job_hcl": MINI_SPEC})
        for path in ("/v1/jobs", "/v1/job/web-a",
                     "/v1/job/web-a/allocations",
                     "/v1/job/web-a/evaluations", "/v1/job/web-a/summary",
                     "/v1/job/web-a/versions", "/v1/job/web-a/deployment",
                     "/v1/job/mini/allocations", "/v1/evaluations",
                     f"/v1/evaluation/{eid}",
                     f"/v1/evaluation/{eid}/allocations",
                     "/v1/allocations", "/v1/deployments",
                     "/v1/job/nope", "/v1/evaluation/nope",
                     "/v1/allocation/nope", "/v1/node/nope"):
            check(ref, port, "GET", path)
        check(ref, port, "GET", "/v1/jobs", prefix="web-")
        check(ref, port, "GET", "/v1/evaluations", prefix=eid[:8])
        alloc = port[1].get("/v1/job/web-a/allocations")[0]
        check(ref, port, "GET", f"/v1/allocation/{alloc['id']}")
        check(ref, port, "GET", "/v1/allocations", prefix=alloc["id"][:6])
        node_id = alloc["node_id"]
        check(ref, port, "GET", f"/v1/node/{node_id}")
        check(ref, port, "GET", f"/v1/node/{node_id}/allocations")
        check(ref, port, "GET", "/v1/event/stream", poll="true", index=0)

        # deployments: pause, resume, promote (no canaries), fail
        dep = port[1].get("/v1/job/web-a/deployment")
        for path, body in (("pause", {"pause": True}),
                           ("pause", {"pause": False}),
                           ("promote", {}), ("fail", None)):
            check(ref, port, "POST",
                  f"/v1/deployment/{path}/{dep['id']}", body)
        check(ref, port, "POST", "/v1/deployment/pause/nope", {})
        check(ref, port, "GET", "/v1/job/web-a/deployment")

        # versions: stability, a revert, a periodic force refused
        check(ref, port, "POST", "/v1/job/web-b/stable",
              {"job_version": 0, "stable": True})
        for pair, reseed in ((ref, ref_reseed_ids),
                             (port, pst.reseed_ids)):
            reseed(21)
        check(ref, port, "POST", "/v1/job/web-b/revert",
              {"job_version": 0})
        check(ref, port, "POST", "/v1/job/web-b/revert",
              {"job_version": 9})
        check(ref, port, "POST", "/v1/job/web-b/periodic/force")
        for s in (ref[0], port[0]):
            wait_until(lambda s=s: settled(s, [e.id for e in
                                                s.state.evals()]),
                       msg="revert settled")
        check(ref, port, "GET", "/v1/job/web-b/versions")

        # an alloc stopped, a node drained and made eligible again
        for pair, reseed in ((ref, ref_reseed_ids),
                             (port, pst.reseed_ids)):
            reseed(22)
        check(ref, port, "POST", f"/v1/allocation/{alloc['id']}/stop")
        check(ref, port, "POST", "/v1/allocation/nope/stop")
        for s in (ref[0], port[0]):
            wait_until(lambda s=s: settled(s, [e.id for e in
                                                s.state.evals()]),
                       msg="stop settled")
        check(ref, port, "POST", f"/v1/node/{node_id}/eligibility",
              {"eligibility": "ineligible"})
        check(ref, port, "POST", f"/v1/node/{node_id}/eligibility",
              {"eligibility": "eligible"})
        check(ref, port, "POST", f"/v1/node/{node_id}/heartbeat")
        check(ref, port, "POST", "/v1/node/nope/heartbeat")
        check(ref, port, "GET", "/v1/job/web-a/allocations")
        check(ref, port, "GET", "/v1/job/web-a/summary")

        # deregister and GC
        for pair, reseed in ((ref, ref_reseed_ids),
                             (port, pst.reseed_ids)):
            reseed(23)
        check(ref, port, "DELETE", "/v1/job/web-b")
        check(ref, port, "DELETE", "/v1/job/nope")
        for s in (ref[0], port[0]):
            wait_until(lambda s=s: settled(s, [e.id for e in
                                                s.state.evals()]),
                       msg="deregister settled")
        check(ref, port, "GET", "/v1/job/web-b/allocations")
        check(ref, port, "POST", "/v1/system/gc")
        check(ref, port, "POST", "/v1/operator/scheduler/configuration",
              {"scheduler_algorithm": "tpu-binpack"})
        check(ref, port, "GET", "/v1/operator/scheduler/configuration")
        assert_same(ref[0], port[0])


def test_operator_routes_equal_the_reference(monkeypatch):
    with agents(monkeypatch) as (ref, port):
        try:
            for body in ({"point": "plan.apply", "action": "delay",
                          "delay_s": 0.0, "count": 2},
                         {"point": "heartbeat", "action": "error"}):
                check(ref, port, "POST", "/v1/operator/faults", body)
            check(ref, port, "GET", "/v1/operator/faults")
            check(ref, port, "POST", "/v1/operator/faults",
                  {"point": "plan.apply", "disarm": True})
            check(ref, port, "POST", "/v1/operator/faults",
                  {"disarm": True})
            check(ref, port, "POST", "/v1/operator/faults",
                  {"disarm_all": True})
            assert faults.snapshot() == {"faults": []}
        finally:
            faults.disarm_all()
            ref_faults.disarm_all()
        check(ref, port, "POST", "/v1/operator/quarantine",
              {"release_all": True})
        check(ref, port, "POST", "/v1/operator/quarantine", {})
        # routes the port does not serve answer as unknown paths
        for method, path in (("GET", "/v1/acl/policies"),
                             ("GET", "/v1/namespaces"),
                             ("GET", "/v1/vars"),
                             ("POST", "/v1/search"),
                             ("GET", "/v1/services"),
                             ("GET", "/v1/agent/members"),
                             ("GET", "/v1/regions"),
                             ("POST", "/v1/agent/jax-profile")):
            status, reply = ask(port, method, path, {})
            assert status == 404, (path, status)
            assert reply.endswith(f"unknown path {path}"), reply


def test_guard_reprobe_equals_the_reference(monkeypatch):
    """The guard wedged (init timed out): the reprobe's subprocess sees a
    card, so the verdict is 'transport healthy, process wedged' in both;
    /v1/agent/self's guard block then shows the same flags."""
    for g in (guard, ref_guard):
        g._reset_for_tests()
        g._STATE.update(checked=True, ok=False, probe_timed_out=True)
        monkeypatch.setattr(g, "_subprocess_probe", lambda timeout: {
            "timed_out": False, "rc": 0, "devices": 1})
    monkeypatch.setattr(guard, "_FLAGS", (True, False))
    monkeypatch.setattr(ref_guard, "_FLAGS", (True, False))
    with agents(monkeypatch) as (ref, port):
        got, want = both(ref, port, "POST", "/v1/operator/solver/reprobe")
        assert got[0] == want[0] == 200
        for k in ("recovered", "subprocess", "tunnel_ok_process_wedged"):
            assert got[1][k] == want[1][k], k
        assert got[1]["tunnel_ok_process_wedged"] is True
        gs, ws = got[1]["state"], want[1]["state"]
        for k in ("checked", "ok", "probe_timed_out", "degraded",
                  "recovered_late"):
            same(gs[k], ws[k], k)
        same(gs["dispatch"], {k: v for k, v in ws["dispatch"].items()
                              if k != "bytes_total"})
        # the port's breaker also names the platform of its last dispatch
        same({k: v for k, v in gs["breaker"].items() if k != "platform"},
             ws["breaker"])


def test_agent_self_carries_every_block(monkeypatch):
    with agents(monkeypatch) as (ref, port):
        register_both(ref, port, {"job": json_job("self-job")}, 31)
        got, want = both(ref, port, "GET", "/v1/agent/self")
        got, want = got[1], want[1]
        same(got["config"], want["config"])
        same(got["member"], want["member"])
        assert set(got["stats"]) == set(want["stats"]) - {"shardcheck"}
        for k in ("nomad", "node_flaps", "eval_quarantine", "lockcheck",
                  "statecheck", "schedcheck"):
            same(got["stats"][k], want["stats"][k], k)
        gs, ws = got["stats"]["solver_guard"], want["stats"]["solver_guard"]
        # the resident set stands where the reference's const cache is
        assert set(gs) - {"resident", "placements_host_fallback"} == \
            set(ws) - {"const_cache"}
        for k in ("pack_cache", "pack", "mesh"):
            assert set(gs[k]) == set(ws[k]), k
        same(gs["dispatch"], {k: v for k, v in ws["dispatch"].items()
                              if k != "bytes_total"})
        for k in ("enabled", "stall_s", "restarts_total",
                  "deaths_detected", "wedges_detected"):
            assert got["stats"]["worker_pool"][k] == \
                want["stats"]["worker_pool"][k], k
        assert set(got["stats"]["xferobs"]) == set(want["stats"]["xferobs"])
        for k in ("enabled", "host_sync_count", "mutation_count",
                  "x64_leak_count"):
            assert got["stats"]["jitcheck"][k] == \
                want["stats"]["jitcheck"][k], k


def test_metrics_and_prometheus_names_equal_the_reference(monkeypatch):
    with agents(monkeypatch) as (ref, port):
        register_both(ref, port, {"job": json_job("met-job", count=4)}, 41)
        got, want = both(ref, port, "GET", "/v1/metrics")
        got, want = got[1], want[1]
        assert set(got) == set(want)
        assert deterministic(got["counters"]) == \
            deterministic(want["counters"])
        for k in ("plans_applied", "plans_rejected", "state_index",
                  "tpu_placement_ratio", "blocked_evals"):
            same(got[k], want[k], k)
        assert set(got["quality"]) == set(want["quality"])
        texts = []
        for _, api in (ref, port):
            with urllib.request.urlopen(
                    f"{api.address}/v1/metrics?format=prometheus") as r:
                assert r.headers["Content-Type"].startswith("text/plain")
                texts.append(r.read().decode())

        def names(text):
            return {ln.split()[2] for ln in text.splitlines()
                    if ln.startswith("# TYPE ")}

        def counter_names(m):
            return {port_http.prometheus_text({"counters": {k: v}})
                    .split()[2] for k, v in deterministic(
                        m["counters"]).items()}
        want_names = counter_names(want)
        assert want_names and want_names <= names(texts[1])
        assert want_names <= names(texts[0])
        assert "nomad_scheduler_placements_tpu" in names(texts[1])
        assert "nomad_plans_applied" in names(texts[1])
        same(port_http.prometheus_text(want), ref_http.prometheus_text(want))


def test_trace_and_quality_routes(monkeypatch):
    # every trace kept in both (a slow first dispatch is kept anyway)
    monkeypatch.setenv("NOMAD_TPU_TRACE_SAMPLE", "1.0")
    monkeypatch.setenv("NOMAD_TPU_TORCH_TRACE_SAMPLE", "1.0")
    with agents(monkeypatch) as (ref, port):
        eid = register_both(ref, port, {"job": json_job("tr-job")}, 51)
        got, want = both(ref, port, "GET", f"/v1/agent/trace/{eid}")
        assert got[0] == want[0] == 200
        assert {s["name"] for s in got[1]["spans"]} == \
            {s["name"] for s in want[1]["spans"]}
        got, want = both(ref, port, "GET", "/v1/agent/trace")
        assert set(got[1]) == set(want[1]) == {"traces", "stats"}
        assert len(got[1]["traces"]) == len(want[1]["traces"])
        got, want = both(ref, port, "GET", "/v1/agent/trace",
                         format="chrome")
        assert set(got[1]) == set(want[1])
        check(ref, port, "GET", "/v1/agent/trace/nope")
        check(ref, port, "GET", "/v1/agent/trace", slowest="x")
        got, want = both(ref, port, "GET", "/v1/operator/quality")
        assert set(got[1]) == set(want[1])


def test_node_allocations_blocking_query(monkeypatch):
    """A node's watch blocks on the allocs table: past the index it
    returns at once; at the index it returns when a placement lands
    (here a job registered from another thread), with the new index."""
    with agents(monkeypatch) as (_, (server, api)):
        node_id = server.state.nodes()[0].id
        first = api.request("GET", f"/v1/node/{node_id}/allocations",
                            params={"index": 0, "wait": "5s"})
        assert first["allocs"] == []
        idx = first["index"]
        out = {}

        def watch():
            out["reply"] = api.request(
                "GET", f"/v1/node/{node_id}/allocations",
                params={"index": idx, "wait": "20s"}, timeout=30.0)
        t = threading.Thread(target=watch, name="watch")
        t.start()
        job = pmock.job(id="block-job")
        job.task_groups[0].count = N_NODES
        server.register_job(job)
        t.join(timeout=30.0)
        assert not t.is_alive()
        reply = out["reply"]
        assert reply["index"] > idx
        assert reply["allocs"] and all(a["node_id"] == node_id
                                       for a in reply["allocs"])


def test_node_agent_round_trip_through_http_server_conn(monkeypatch):
    """What a client agent sends: register, heartbeat, pull the allocs of
    a job pinned to it (blocking), report them running, read one back;
    the same in both."""
    with agents(monkeypatch) as (ref, port):
        got = []
        for pair, conn_cls, mk, reseed, cls in (
                (ref, RefServerConn, mock, ref_reseed_ids, None),
                (port, HttpServerConn, pmock, pst.reseed_ids, pst)):
            server, api = pair
            reseed(61)
            node = mk.node(id="agent-node-0")
            node.compute_class()
            conn = conn_cls(api.address)
            conn.register_node(node)
            assert conn.heartbeat(node.id) == 3600.0
            assert conn.heartbeat("nope") == 0.0
            job = ref_http.to_jsonable(mock.job(id="pinned"))
            job["constraints"] = [{"l_target": "${node.unique.id}",
                                   "r_target": node.id, "operand": "="}]
            job["task_groups"][0]["count"] = 2
            eid = api.register_job(job)["eval_id"]
            wait_until(lambda s=server, e=eid: settled(s, [e]),
                       msg="pinned job")
            allocs, index = conn.pull_allocs(node.id, 0, 5.0)
            assert len(allocs) == 2 and index > 0
            for a in allocs:
                a.client_status = "running"
            conn.update_allocs(allocs)
            back = conn.get_alloc(allocs[0].id)
            assert back.client_status == "running"
            assert conn.get_alloc("nope") is None
            got.append(sorted((a.name, a.node_id, a.client_status)
                              for a in server.state.allocs_by_job(
                                  "default", "pinned")))
        assert got[0] == got[1]
        assert all(row[1] == "agent-node-0" for row in got[1])


def _in_process(server, job):
    """register_job from a request-named thread: the eval id the same
    request through the API would mint."""
    out = {}
    t = threading.Thread(target=lambda: out.update(
        ev=server.register_job(job)), name="http-request")
    t.start()
    t.join(timeout=30.0)
    return out["ev"]


@pytest.mark.parametrize("route", ["json", "hcl"])
def test_http_placements_equal_the_in_process_server(monkeypatch, route):
    """Jobs through POST /v1/jobs and the same Job structs through
    register_job in process: equal placements (alloc name -> node) and
    float64 scores at rtol 1e-12."""
    store = ref_world(seed=4, n=8)
    kw = dict(num_workers=2, eval_batching=True, batch_width=WIDTH,
              heartbeat_ttl=3600.0, device="cpu")
    via = Server(state=store_from_reference(store.snapshot()), **kw)
    direct = Server(state=store_from_reference(store.snapshot()), **kw)
    http = None
    try:
        via.start()
        direct.start()
        http = port_http.HttpServer(via, port=0)
        http.start()
        api = ApiClient(f"http://127.0.0.1:{http.port}")
        for k in range(3):
            if route == "json":
                ref_job = mock.job(id=f"pj-{k}")
                ref_job.task_groups[0].count = 5
                job = struct_from_reference(ref_job)
                body = {"job": ref_http.to_jsonable(ref_job)}
            else:
                src = MINI_SPEC.replace('"mini"', f'"pj-{k}"')
                job = pst.Job()
                from nomad_tpu_torch.jobspec import parse
                job = parse(src)
                body = {"job_hcl": src}
            pst.reseed_ids(70 + k)
            eid = api.post("/v1/jobs", body)["eval_id"]
            wait_until(lambda: settled(via, [eid]), msg="via http")
            pst.reseed_ids(70 + k)
            ev = _in_process(direct, job)
            assert ev.id == eid
            wait_until(lambda: settled(direct, [ev.id]), msg="in process")
        assert_same(direct, via)
    finally:
        if http is not None:
            http.shutdown()
        via.shutdown()
        direct.shutdown()


def test_paused_burst_through_http_equals_in_process(monkeypatch):
    """The broker paused through the API, four jobs that contend for the
    same nodes registered, the broker resumed: one batch of four lanes
    (their fixpoint settles the conflicts in dequeue order), and the
    placements equal an in-process Server's under the same protocol."""
    order = InOrderLanes(monkeypatch, plans=True)
    store = ref_world(seed=5, n=5)
    kw = dict(num_workers=2, eval_batching=True, batch_width=WIDTH,
              heartbeat_ttl=3600.0, device="cpu")
    via = order.attach(Server(state=store_from_reference(store.snapshot()),
                              **kw))
    direct = order.attach(Server(
        state=store_from_reference(store.snapshot()), **kw))
    http = None
    jobs = []
    for k in range(WIDTH):
        j = mock.job(id=f"burst-{k}")
        j.task_groups[0].count = 6
        j.task_groups[0].tasks[0].resources.cpu = 1000
        jobs.append(j)
    try:
        via.start()
        direct.start()
        http = port_http.HttpServer(via, port=0)
        http.start()
        api = ApiClient(f"http://127.0.0.1:{http.port}")
        cfg = {"scheduler_algorithm": "tpu-binpack"}
        api.post("/v1/operator/scheduler/configuration",
                 dict(cfg, pause_eval_broker=True))
        pst.reseed_ids(80)
        ids = [api.register_job(ref_http.to_jsonable(j))["eval_id"]
               for j in jobs]
        api.post("/v1/operator/scheduler/configuration", cfg)
        wait_until(lambda: settled(via, ids), msg="via http")
        direct.apply_scheduler_config(pst.SchedulerConfiguration(
            scheduler_algorithm="tpu-binpack", pause_eval_broker=True))
        pst.reseed_ids(80)
        got = [_in_process(direct, struct_from_reference(j)).id
               for j in jobs]
        assert got == ids
        direct.apply_scheduler_config(pst.SchedulerConfiguration(
            scheduler_algorithm="tpu-binpack"))
        wait_until(lambda: settled(direct, ids), msg="in process")
        for s in (via, direct):
            assert s.workers[0].batches_processed + \
                s.workers[1].batches_processed == 1
        assert_same(direct, via)
        placed = [a for a in via.state.allocs() if not a.terminal_status()]
        assert 0 < len(placed) < WIDTH * 6      # the fleet is contended
    finally:
        if http is not None:
            http.shutdown()
        via.shutdown()
        direct.shutdown()


def test_guard_state_blocks_equal_the_reference(monkeypatch):
    """guard.state()'s pack_cache, pack and mesh blocks after the same
    dispatches: the reference's keys, and its counters (the pack's wall
    times and the card count, which only the reference's virtual XLA
    devices give here, aside)."""
    for g in (guard, ref_guard):
        g._reset_for_tests()
    with agents(monkeypatch) as (ref, port):
        register_both(ref, port, {"job": json_job("gs-a", count=4)}, 131)
        register_both(ref, port, {"job": json_job("gs-b", count=2)}, 132)
        got, want = guard.state(), ref_guard.state()
    assert set(got["pack_cache"]) == set(want["pack_cache"])
    for k in sorted(want["pack_cache"]):
        assert got["pack_cache"][k] == want["pack_cache"][k], k
    assert set(got["pack"]) == set(want["pack"]) == {"ms", "cache_hit",
                                                     "cache_miss"}
    assert set(got["pack"]["ms"]) == set(want["pack"]["ms"])
    assert got["pack"]["ms"]["count"] == want["pack"]["ms"]["count"] == 2
    for k in ("cache_hit", "cache_miss"):
        assert got["pack"][k] == want["pack"][k], k
    assert set(got["mesh"]) == set(want["mesh"])
    for k in ("enabled", "dispatches", "lpq_dispatches"):
        assert got["mesh"][k] == want["mesh"][k], k
    assert got["mesh"]["devices"] == 0 and got["mesh"]["grid"] is None


# --------------------------------------------------------------------------
# the job operations and the snapshots (the reference's
# tests/test_job_lifecycle.py::test_http_versions_revert_scale_dispatch,
# tests/test_jobspec_cli.py::test_api_client_hcl_register_and_plan and
# ::test_plan_reports_infeasible, tests/test_snapshot_events.py::
# test_http_snapshot_endpoints)

class _PinnedTime:
    """The time module with time() pinned: a dispatched child's id (and
    a scaling event's time) read one second in both servers."""

    def __init__(self, now):
        self.now = now

    def time(self):
        return self.now

    def __getattr__(self, name):
        import time as _time
        return getattr(_time, name)


def check_seeded(ref, port, seed, method, path, body=None, **params):
    """check() with both id streams reseeded alike before each side."""
    out = []
    for pair, reseed in ((ref, ref_reseed_ids), (port, pst.reseed_ids)):
        reseed(seed)
        status, reply = ask(pair, method, path, body, **params)
        out.append((status, norm(reply, id_names(pair[0]))))
    same(out[1], out[0])
    return out[1]


def settle_every_eval(*pairs):
    for server, _ in pairs:
        wait_until(lambda s=server: settled(
            s, [e.id for e in s.state.evals()]), msg="settled")


def test_job_op_routes_equal_the_reference(monkeypatch):
    from nomad_tpu.server import core as ref_core
    from nomad_tpu_torch.server import core as port_core
    clock = _PinnedTime(1_700_000_000.0)
    monkeypatch.setattr(ref_core, "time", clock)
    monkeypatch.setattr(port_core, "time", clock)
    with agents(monkeypatch) as (ref, port):
        # plans: a JSON job, HCL (nothing committed), a refused one
        got = check_seeded(ref, port, 201, "POST", "/v1/job/web-p/plan",
                           {"job": json_job("web-p", count=4)})
        assert got[1]["placed"] == 4 and got[1]["diff_type"] == "Added"
        got = check_seeded(ref, port, 202, "POST", "/v1/job/mini/plan",
                           {"job_hcl": MINI_SPEC})
        assert got[1]["placed"] == 2 and not got[1]["failed_tg_allocs"]
        bad = json_job("web-x")
        bad["namespace"] = "nowhere"
        assert check_seeded(ref, port, 203, "POST", "/v1/job/web-x/plan",
                            {"job": bad})[0] == 400
        check(ref, port, "GET", "/v1/jobs")
        # an ask no node holds: equal but for the failed group's metrics,
        # which the port counts from the solved lane's tables
        out = []
        for pair, reseed in ((ref, ref_reseed_ids), (port, pst.reseed_ids)):
            reseed(204)
            out.append(ask(pair, "POST", "/v1/job/big/plan",
                           {"job": json_job("big", cpu=9000)}))
        (rs, rplan), (ps, pplan) = out
        assert rs == ps == 200 and rplan["placed"] == pplan["placed"] == 0
        assert rplan["failed_tg_allocs"]["web"]["nodes_evaluated"] == 0
        assert pplan["failed_tg_allocs"]["web"]["nodes_evaluated"] == \
            N_NODES
        assert pplan["failed_tg_allocs"]["web"]["dimension_exhausted"] == \
            {"cpu": N_NODES}
        # scale: a job with a scaling block, its policy, a scale within
        # and outside the bounds, the status with its event
        scaly = json_job("scaly", count=2)
        scaly["task_groups"][0]["scaling"] = {"min": 1, "max": 5}
        register_both(ref, port, {"job": scaly}, 205)
        pols = check(ref, port, "GET", "/v1/scaling/policies", job="scaly")
        assert len(pols[1]) == 1 and pols[1][0]["max"] == 5
        check(ref, port, "GET", "/v1/scaling/policies")
        check(ref, port, "GET", f"/v1/scaling/policy/{pols[1][0]['id']}")
        check(ref, port, "GET", "/v1/scaling/policy/nope")
        check_seeded(ref, port, 206, "POST", "/v1/job/scaly/scale",
                     {"count": 4, "target": {"Group": "web"},
                      "message": "more"})
        settle_every_eval(ref, port)
        for body in ({"count": 9, "target": {"Group": "web"}},
                     {"count": 3, "target": {"Group": "nope"}},
                     {"count": "x", "target": {"Group": "web"}}):
            assert check_seeded(ref, port, 207, "POST",
                                "/v1/job/scaly/scale", body)[0] == 400
        got = check(ref, port, "GET", "/v1/job/scaly/scale")
        web = got[1]["task_groups"]["web"]
        assert web["desired"] == web["placed"] == 4
        assert [e["message"] for e in web["events"]] == ["more"]
        check(ref, port, "GET", "/v1/job/nope/scale")
        check(ref, port, "GET", "/v1/job/scaly/allocations")
        # dispatch: a parameterized batch job, a child with its payload,
        # the same token again, a missing required key
        batcher = json_job("batcher", count=2)
        batcher["type"] = "batch"
        batcher["parameterized"] = {"meta_required": ["k"]}
        register_both_no_eval(ref, port, {"job": batcher}, 208)
        import base64
        body = {"payload": base64.b64encode(b"payload").decode(),
                "meta": {"k": "v"}, "idempotency_token": "t-1"}
        got = check_seeded(ref, port, 209, "POST",
                           "/v1/job/batcher/dispatch", body)
        child = got[1]["dispatched_job_id"]
        assert child.startswith("batcher/dispatch-1700000000-")
        again = check_seeded(ref, port, 210, "POST",
                             "/v1/job/batcher/dispatch", body)
        assert again[1]["dispatched_job_id"] == child
        assert again[1]["eval_id"] == ""
        assert check_seeded(ref, port, 211, "POST",
                            "/v1/job/batcher/dispatch",
                            {"payload": "", "meta": {}})[0] == 400
        assert check_seeded(ref, port, 212, "POST",
                            "/v1/job/batcher/dispatch",
                            {"payload": "abc", "meta": {"k": "v"}})[0] == 400
        settle_every_eval(ref, port)
        check(ref, port, "GET", f"/v1/job/{child}/allocations")
        assert port[0].state.job_by_id("default", child).payload == \
            b"payload"
        check(ref, port, "GET", "/v1/jobs")
        assert_same(ref[0], port[0])


def register_both_no_eval(ref, port, body, seed):
    """Register a job that gets no eval (parameterized, periodic) in both."""
    for pair, reseed in ((ref, ref_reseed_ids), (port, pst.reseed_ids)):
        reseed(seed)
        status, reply = ask(pair, "POST", "/v1/jobs", body)
        assert status == 200 and reply["eval_id"] == "", reply


def test_snapshot_routes_on_both_agents(monkeypatch):
    """GET /v1/operator/snapshot answers an archive; a job deleted, then
    the archive PUT back, restores it; junk answers 400. Each agent
    restores the other package's archive too."""
    from nomad_tpu.server.snapshot import load_archive as ref_load
    from nomad_tpu_torch.server.snapshot import load_archive
    with agents(monkeypatch) as (ref, port):
        register_both(ref, port, {"job": json_job("httpjob")}, 220)
        archives = {}
        for name, (server, api), load in (("ref", ref, ref_load),
                                          ("port", port, load_archive)):
            data = api.snapshot_save()
            assert len(data) > 100
            meta, blob = load(data)
            assert meta["index"] == server.state.latest_index()
            archives[name] = data
            server.state.delete_job("default", "httpjob")
            assert server.state.job_by_id("default", "httpjob") is None
        replies = [api.snapshot_restore(archives[name])
                   for name, (_, api) in (("ref", ref), ("port", port))]
        assert replies[0] == replies[1]
        assert replies[1]["restored"] is True
        for server, _ in (ref, port):
            assert server.state.job_by_id("default", "httpjob") is not None
        for pair in (ref, port):
            server, api = pair
            with pytest.raises(Exception) as err:
                api.snapshot_restore(b"junk")
            assert err.value.status == 400
        # each package's archive restores in the other's agent
        port[1].snapshot_restore(archives["ref"])
        ref[1].snapshot_restore(archives["port"])
        check(ref, port, "GET", "/v1/jobs")
        check(ref, port, "GET", "/v1/job/httpjob/allocations")
        assert port[0].is_leader()
