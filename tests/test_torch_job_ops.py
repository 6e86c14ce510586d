"""The port's job operations (nomad_tpu_torch/server/core.py plan_job,
dispatch_job, scale_job, job_scale_status) held against the JAX
package's on the CPU.

Each world is built with the reference's mock and store and carried
into the port (carry.store_from_reference): a reference Server and a
port Server (device="cpu", tpu-binpack) start on it at one index, with
their leader loops off (test_torch_server.fresh_state). Both id streams
are reseeded alike before each side of a comparison, so a dry run's
eval id, and the node shuffle it seeds, is the same in both.

  * ``plan_job``: the answer dicts are equal for a new job (Added), a
    count raised and lowered (Edited: places and stops), a spread job,
    a system job and the namespace default-pool rewrite (after
    tests/test_namespaces_pools.py:220). A group the device path fails
    is reported by the reference with an empty metric; the port
    reports the metrics of the reference's host scheduler for it (an
    ask no node holds, and one that fills the fleet).
  * The Connect case: the reference plans without the sidecar its
    registration adds (a reference fault); the port's plan admits the
    job as registration does and predicts what ``job run`` places.
  * A dry run changes nothing: dump_state of the real store is
    byte-equal before and after; a plan run in the middle of a
    registration burst leaves the burst's placements equal to a twin
    server's that never planned.
  * Dispatch and scale: the cases of tests/test_job_lifecycle.py:81-345
    through both packages, with the children's and the scaled jobs'
    placements equal node for node (scores at rtol 1e-12). A child's id
    carries the wall-clock second: both servers' clocks are pinned to
    one second for those cases.
"""
import copy
import itertools
import json
import threading

import pytest
import torch

from nomad_tpu import mock
from nomad_tpu.server import Server as RefServer
from nomad_tpu.server import core as ref_core
from nomad_tpu.state import StateStore as RefStateStore
from nomad_tpu.structs import (
    Constraint, DeviceRequest, Namespace, NamespaceNodePoolConfiguration,
    NetworkResource, NodePool, ParameterizedJobConfig, Port,
    SchedulerConfiguration, Service, Spread)
from nomad_tpu.structs.job import reseed_ids as ref_reseed_ids

from nomad_tpu_torch import structs as pst
from nomad_tpu_torch.carry import store_from_reference, struct_from_reference
from nomad_tpu_torch.server import Server
from nomad_tpu_torch.server import core as port_core
from nomad_tpu_torch.solver import service as port_service
from nomad_tpu_torch.state.restore import dump_state

from test_torch_http import _PinnedTime
from test_torch_server import (  # noqa: F401 -- fresh_state is autouse
    InOrderLanes, assert_same, fresh_state, server_pair, settle_both,
    settled, wait_until)

torch.set_num_threads(1)

N_NODES = 8


def world(seed=3, n=N_NODES, setup=None, alg="tpu-binpack"):
    """A reference store of ``n`` mock nodes under ``alg``;
    ``setup(store)`` adds to it before the nodes are written."""
    ref_reseed_ids(seed)
    mock._counter = itertools.count()
    store = RefStateStore()
    store.set_scheduler_config(SchedulerConfiguration(
        scheduler_algorithm=alg))
    if setup is not None:
        setup(store)
    for _ in range(n):
        store.upsert_node(mock.node())
    return store


def plan_both(ref, port, job, seed):
    """plan_job of ``job`` (a reference struct) in both, ids seeded
    alike; (port answer, reference answer)."""
    pjob = struct_from_reference(job)
    ref_reseed_ids(seed)
    want = ref.plan_job(copy.deepcopy(job))
    pst.reseed_ids(seed)
    got = port.plan_job(pjob)
    return got, want


def register_both(ref, port, job, seed):
    """register_job in both, ids seeded alike, settled."""
    pjob = struct_from_reference(job)
    ref_reseed_ids(seed)
    ev = ref.register_job(copy.deepcopy(job))
    pst.reseed_ids(seed)
    pev = port.register_job(pjob)
    ids = [e.id for e in (ev, pev) if e is not None]
    if ids:
        assert ev.id == pev.id
        settle_both(ref, port, [ev.id])
    return ev, pev


def web_job(job_id, count, cpu=500):
    j = mock.job(id=job_id)
    j.task_groups[0].count = count
    j.task_groups[0].tasks[0].resources.cpu = cpu
    return j


# --------------------------------------------------------------------------
# plan_job

def _case_added(ref, port):
    return [(web_job("plan-a", 6), None)]


def _case_edited(ref, port):
    register_both(ref, port, web_job("plan-e", 4), 31)
    return [(web_job("plan-e", 7), "place"), (web_job("plan-e", 1), "stop")]


def _case_spread(ref, port):
    j = web_job("plan-spread", 5)
    j.task_groups[0].spreads = [Spread(attribute="${node.unique.id}",
                                       weight=100)]
    return [(j, None)]


def _case_system(ref, port):
    j = mock.system_job(id="plan-sys")
    j.task_groups[0].tasks[0].resources.cpu = 100
    return [(j, None)]


def _setup_cheap_pool(store):
    store.upsert_node_pool(NodePool(name="cheap"))
    store.upsert_namespace(Namespace(
        name="rewritten",
        node_pool_configuration=NamespaceNodePoolConfiguration(
            default="cheap")))
    for _ in range(3):
        store.upsert_node(mock.node(node_pool="cheap"))


def _case_default_pool(ref, port):
    j = web_job("plan-pool", 2)
    j.namespace = "rewritten"
    return [(j, "pool")]


PLAN_CASES = {
    "added": (_case_added, None),
    "edited": (_case_edited, None),
    "spread": (_case_spread, None),
    "system": (_case_system, None),
    "default_pool": (_case_default_pool, _setup_cheap_pool),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plan_answers_equal_the_reference(case):
    build, setup = PLAN_CASES[case]
    store = world(setup=setup)
    with server_pair(store) as (ref, port, _):
        for k, (job, what) in enumerate(build(ref, port)):
            before = json.dumps(dump_state(port.state), sort_keys=True)
            got, want = plan_both(ref, port, job, 40 + k)
            assert got == want, (case, got, want)
            assert json.dumps(dump_state(port.state),
                              sort_keys=True) == before
            if what == "place":
                # the 4 running allocs update in place (a place each)
                assert got["diff_type"] == "Edited" and got["placed"] == 7
            elif what == "stop":
                assert got["stopped"] == 3 and got["placed"] == 1
                assert got["annotations"]["desired_tg_updates"]["web"][
                    "stop"] == 3
            elif what == "pool":
                assert got["placed"] == 2
                assert port.state.job_by_id("rewritten", job.id) is None
            else:
                assert got["placed"] > 0 and not got["failed_tg_allocs"]
        # the dry runs committed nothing in either server
        assert_same(ref, port)


def _fail_memory():
    j = web_job("plan-big", 2, cpu=100)
    j.task_groups[0].tasks[0].resources.memory_mb = 9000
    return j


def _fail_filtered():
    j = web_job("plan-big", 2, cpu=9000)
    j.constraints = [Constraint(l_target="${attr.kernel.name}",
                                r_target="linux", operand="=")]
    return j


def _two_windows_nodes(store):
    for _ in range(2):
        n = mock.node()
        n.attributes["kernel.name"] = "windows"
        n.compute_class()
        store.upsert_node(n)


def _fail_distinct_hosts():
    j = web_job("plan-big", 10, cpu=100)
    j.constraints = [Constraint(operand="distinct_hosts", r_target="true")]
    return j


def _fail_static_port():
    j = web_job("plan-big", 10, cpu=100)
    j.task_groups[0].networks = [NetworkResource(
        reserved_ports=[Port(label="adm", value=9800)])]
    return j


def _fail_cores():
    j = web_job("plan-big", 10, cpu=100)
    j.task_groups[0].tasks[0].resources.cores = 3
    return j


def _fail_unique():
    j = web_job("plan-big", 40, cpu=1000)
    j.constraints = [Constraint(l_target="${node.unique.name}",
                                r_target="node-0", operand="!=")]
    return j


def _two_gpu_nodes(store):
    for _ in range(2):
        store.upsert_node(mock.gpu_node(count=2))


def _fail_devices():
    j = web_job("plan-big", 5, cpu=100)
    j.task_groups[0].tasks[0].resources.devices = [
        DeviceRequest(name="nvidia/gpu", count=1)]
    return j


# case: (job, world setup, placed, the host's explanation where pinned)
FAIL_CASES = {
    "none_fits": (lambda: web_job("plan-big", 2, cpu=9000), None, 0,
                  (N_NODES, 0, {}, {"cpu": N_NODES})),
    "some_fit": (lambda: web_job("plan-big", 70, cpu=500), None, 64,
                 (N_NODES, 0, {}, {"cpu": N_NODES})),
    "memory": (_fail_memory, None, 0,
               (N_NODES, 0, {}, {"memory": N_NODES})),
    "filtered": (_fail_filtered, _two_windows_nodes, 0,
                 (N_NODES + 2, 2, {"${attr.kernel.name} = linux": 1},
                  {"cpu": N_NODES})),
    "distinct_hosts": (_fail_distinct_hosts, None, N_NODES,
                       (N_NODES, N_NODES, {"distinct_hosts": N_NODES}, {})),
    "static_port": (_fail_static_port, None, N_NODES,
                    (N_NODES, 0, {}, {
                        "network: reserved port collision adm=9800":
                        N_NODES})),
    "cores": (_fail_cores, None, N_NODES,
              (N_NODES, 0, {}, {"cores": N_NODES})),
    "unique": (_fail_unique, None, 4 * (N_NODES - 1),
               (N_NODES, 1, {"${node.unique.name} != node-0": 1},
                {"cpu": N_NODES - 1})),
    "devices": (_fail_devices, _two_gpu_nodes, 4,
                (N_NODES + 2, N_NODES, {},
                 {"devices: no devices match request": 2})),
}


@pytest.mark.parametrize("case", list(FAIL_CASES))
def test_plan_failures_are_explained_as_the_host_stack_explains_them(
        case, monkeypatch):
    """A group the device path fails: the reference's dry run reports it
    with no node evaluated and no dimension exhausted (the device path's
    metric); the port's, counted from the solved lane's tables, names
    the group with the metrics the reference's own host scheduler
    (binpack) reports for it: nodes evaluated and filtered, the
    constraint, the dimension each node ran out of. The rest of the
    answer equals the reference's."""
    build, setup, placed, pinned = FAIL_CASES[case]
    host = RefServer(state=world(setup=setup, alg="binpack"), num_workers=2,
                     heartbeat_ttl=3600.0)
    host.start()
    try:
        ref_reseed_ids(40)
        explained = host.plan_job(build())["failed_tg_allocs"]
    finally:
        host.shutdown()
    web = explained["web"]
    assert (web["nodes_evaluated"], web["nodes_filtered"],
            web["constraint_filtered"], web["dimension_exhausted"]) == \
        pinned, web
    counted = []
    explain = port_service.failure_metric

    def counting(*a):
        counted.append(1)
        return explain(*a)
    monkeypatch.setattr(port_service, "failure_metric", counting)
    with server_pair(world(setup=setup)) as (ref, port, _):
        before = json.dumps(dump_state(port.state), sort_keys=True)
        got, want = plan_both(ref, port, build(), 40)
        assert json.dumps(dump_state(port.state), sort_keys=True) == before
        # the device path solved the group and counted its failure once
        assert counted == [1]
        bare = {"nodes_evaluated": 0, "nodes_filtered": 0,
                "constraint_filtered": {}, "dimension_exhausted": {}}
        job = build()
        if setup is None and all(c.operand == "distinct_hosts"
                                 for c in job.constraints):
            assert want["failed_tg_allocs"]["web"] == bare
        else:
            # the reference's base metric keeps the feasibility pack's
            # checks where a node fails one
            assert want["failed_tg_allocs"]["web"]["nodes_evaluated"] == 0
            assert want["failed_tg_allocs"]["web"][
                "dimension_exhausted"] == {}
        assert got["failed_tg_allocs"] == explained
        assert {k: v for k, v in got.items() if k != "failed_tg_allocs"} \
            == {k: v for k, v in want.items() if k != "failed_tg_allocs"}
        assert got["placed"] == placed
        assert_same(ref, port)


def test_plan_applies_the_default_pool_rewrite_and_refuses_bad_input():
    """_validate_job runs before the dry run: the namespace's default
    pool is written into the caller's job; an unknown namespace and the
    "all" pool are refused in both packages."""
    store = world(setup=_setup_cheap_pool)
    with server_pair(store) as (ref, port, _):
        for server, conv in ((ref, lambda j: j),
                             (port, struct_from_reference)):
            j = conv(web_job("planned", 1))
            j.namespace = "rewritten"
            server.plan_job(j)
            assert j.node_pool == "cheap"
            for field, value in (("namespace", "nonexistent"),
                                 ("node_pool", "all")):
                bad = conv(web_job("planned-bad", 1))
                setattr(bad, field, value)
                with pytest.raises(ValueError):
                    server.plan_job(bad)


def _connect_job():
    j = web_job("plan-connect", 8, cpu=480)
    j.task_groups[0].services = [Service(
        name="web", port_label="http", connect={"sidecar_service": {}})]
    return j


def _connect_world(store):
    n = mock.node()
    n.attributes["driver.raw_exec"] = "1"      # the sidecar's driver
    n.compute_class()
    store.upsert_node(n)


def test_connect_plan_predicts_the_registration_in_the_port_only():
    """One node of 4,000 MHz; 8 allocs of 480 MHz fit (3,840), but not
    with the Connect sidecar (50 MHz each) that admission injects.
    The reference's dry run skips admission and predicts 8 placed and no
    failure; its registration places 7. The port's dry run admits the
    job first: it predicts the 7 and names the group and the exhausted
    dimension, as its registration then places 7."""
    store = world(n=0, setup=_connect_world)
    with server_pair(store) as (ref, port, _):
        got, want = plan_both(ref, port, _connect_job(), 61)
        assert want["placed"] == 8 and not want["failed_tg_allocs"]
        assert got["placed"] == 7
        assert got["failed_tg_allocs"]["web"]["dimension_exhausted"] == \
            {"cpu": 1}, got
        register_both(ref, port, _connect_job(), 62)
        for server in (ref, port):
            live = [a for a in server.state.allocs()
                    if not a.terminal_status()]
            assert len(live) == 7
        assert_same(ref, port)
        # the caller's job is not admitted in place: no sidecar in it
        pjob = struct_from_reference(_connect_job())
        port.plan_job(pjob)
        assert [t.name for t in pjob.task_groups[0].tasks] == ["web"]


def test_plan_during_a_registration_burst_changes_no_placement(
        monkeypatch):
    """Two port servers on one world, the broker paused, four jobs
    registered alike in both (the fleet holds them all, so no plan is
    retried after a partial rejection: a retry's snapshot depends on
    commit timing), the broker resumed: one of them runs two dry runs
    on another thread while its batch solves. Both commit the same
    placements, and no dry run's job reaches the live store."""
    order = InOrderLanes(monkeypatch, plans=True)
    store = world(seed=5, n=5)
    kw = dict(num_workers=2, eval_batching=True, batch_width=4,
              heartbeat_ttl=3600.0, device="cpu")
    planner = order.attach(Server(
        state=store_from_reference(store.snapshot()), **kw))
    twin = order.attach(Server(
        state=store_from_reference(store.snapshot()), **kw))
    jobs = [web_job(f"burst-{k}", 6, cpu=500) for k in range(4)]
    answers = []
    try:
        planner.start()
        twin.start()
        ids = {}
        for server in (planner, twin):
            server.apply_scheduler_config(pst.SchedulerConfiguration(
                scheduler_algorithm="tpu-binpack", pause_eval_broker=True))
            pst.reseed_ids(80)
            ids[server] = [server.register_job(struct_from_reference(j)).id
                           for j in jobs]
        assert ids[planner] == ids[twin]

        def dry_runs():
            for k in range(2):
                answers.append(planner.plan_job(struct_from_reference(
                    web_job(f"dry-{k}", 3, cpu=1000))))
        t = threading.Thread(target=dry_runs, name="dry-run")
        for server in (planner, twin):
            if server is planner:
                t.start()
            server.apply_scheduler_config(pst.SchedulerConfiguration(
                scheduler_algorithm="tpu-binpack"))
        t.join(timeout=120.0)
        assert not t.is_alive()
        for server in (planner, twin):
            wait_until(lambda s=server: settled(s, ids[s]), msg="burst")
        assert_same(twin, planner)
        assert planner.planner.plans_rejected == 0
        assert len([a for a in planner.state.allocs()
                    if not a.terminal_status()]) == 24
        assert len(answers) == 2
        assert all(a["diff_type"] == "Added" for a in answers)
        assert not any(planner.state.job_by_id("default", f"dry-{k}")
                       for k in range(2))
    finally:
        planner.shutdown()
        twin.shutdown()


# --------------------------------------------------------------------------
# dispatch and scale (tests/test_job_lifecycle.py:81-345)

@pytest.fixture
def pair(monkeypatch):
    clock = _PinnedTime(1_700_000_000.0)
    monkeypatch.setattr(ref_core, "time", clock)
    monkeypatch.setattr(port_core, "time", clock)
    store = world(seed=7, n=6)
    with server_pair(store, num_workers=2) as (ref, port, _):
        yield ref, port


def both(ref, port, fn, seed):
    """fn(server, job_struct_converter) in both, ids seeded alike;
    (port result, reference result) or the exceptions' types."""
    out = []
    for server, conv, reseed in ((port, struct_from_reference,
                                  pst.reseed_ids),
                                 (ref, lambda j: j, ref_reseed_ids)):
        reseed(seed)
        try:
            out.append(fn(server, conv))
        except ValueError as e:
            out.append(("ValueError", str(e)))
    return out


def _param_job(payload="optional", required=(), optional=(), job_id=
               "batcher", ns="default"):
    j = mock.job(id=job_id, type="batch")
    j.namespace = ns
    j.task_groups[0].count = 3
    j.parameterized = ParameterizedJobConfig(
        payload=payload, meta_required=list(required),
        meta_optional=list(optional))
    return j


def _child_view(child, ev):
    return (child.id, child.parent_id, child.dispatched, child.payload,
            sorted(child.meta.items()), child.dispatch_idempotency_token,
            ev.id if ev is not None else None)


def _settle_evals(ref, port):
    settle_both(ref, port, [e.id for e in ref.state.evals()])


def test_dispatch_creates_child_and_places_it_alike(pair):
    ref, port = pair
    for server, conv, reseed in ((port, struct_from_reference,
                                  pst.reseed_ids),
                                 (ref, lambda j: j, ref_reseed_ids)):
        reseed(90)
        assert server.register_job(conv(_param_job(
            required=["input"]))) is None
    got, want = both(ref, port, lambda s, c: _child_view(*s.dispatch_job(
        "default", "batcher", b"data", {"input": "s3://x"})), 91)
    assert got == want
    assert got[0].startswith("batcher/dispatch-1700000000-")
    _settle_evals(ref, port)
    assert port.state.job_by_id("default", got[0]) is not None
    live = [a for a in port.state.allocs() if not a.terminal_status()]
    assert len(live) == 3 and {a.job_id for a in live} == {got[0]}
    assert_same(ref, port)
    topics = [e["topic"] for e in port.events_since(0)]
    assert "JobDispatched" in topics


@pytest.mark.parametrize("kind", ["meta", "payload", "idempotency",
                                  "not_parameterized"])
def test_dispatch_refusals_and_idempotency_equal_the_reference(pair, kind):
    ref, port = pair
    if kind == "meta":
        jobs = [_param_job(required=["input"], optional=["opt"])]
        calls = [("batcher", b"", {}, ""),
                 ("batcher", b"", {"input": "x", "bad": "y"}, ""),
                 ("batcher", b"", {"input": "x", "opt": "o"}, "")]
    elif kind == "payload":
        jobs = [_param_job(payload="required"),
                _param_job(payload="forbidden", job_id="nopay")]
        calls = [("batcher", b"", {}, ""), ("nopay", b"data", {}, ""),
                 ("batcher", b"x" * (16 * 1024 + 1), {}, ""),
                 ("batcher", b"ok", {}, "")]
    elif kind == "idempotency":
        jobs = [_param_job()]
        calls = [("batcher", b"", {}, "tok-1"), ("batcher", b"", {}, "tok-1"),
                 ("batcher", b"", {}, "tok-2")]
    else:
        jobs = [web_job("plain", 2)]
        calls = [("plain", b"", {}, ""), ("missing", b"", {}, "")]
    for k, j in enumerate(jobs):
        register_both(ref, port, j, 100 + k)
    views = []
    for k, (jid, payload, meta, token) in enumerate(calls):
        got, want = both(ref, port, lambda s, c: _child_view(
            *s.dispatch_job("default", jid, payload, meta, token)),
            110 + k)
        assert got == want, (kind, k, got, want)
        views.append(got)
    if kind == "idempotency":
        assert views[1][0] == views[0][0] and views[1][-1] is None
        assert views[2][0] != views[0][0]
    _settle_evals(ref, port)
    assert_same(ref, port)


def test_dispatch_idempotency_is_namespace_scoped():
    store = world(seed=8, n=4, setup=lambda s: s.upsert_namespace(
        Namespace(name="other")))
    with server_pair(store, num_workers=2) as (ref, port, _):
        for k, ns in enumerate(("default", "other")):
            register_both(ref, port, _param_job(job_id="etl", ns=ns), 120 + k)
        got, want = both(ref, port, lambda s, c: [
            (child.namespace, child.parent_id) for child, _ in (
                s.dispatch_job(ns, "etl", b"", {}, idempotency_token="t1")
                for ns in ("default", "other"))], 122)
        assert got == want == [("default", "etl"), ("other", "etl")]
        _settle_evals(ref, port)
        assert_same(ref, port)


def _scaly(scaling=None, count=2, groups=1):
    j = web_job("scaly", count)
    j.task_groups[0].scaling = scaling
    for g in range(1, groups):
        tg2 = copy.deepcopy(j.task_groups[0])
        tg2.name = f"group-{g}"
        j.task_groups.append(tg2)
    return j


def _events(server):
    return [(e.task_group, e.count, e.previous_count, e.message, e.error,
             e.eval_id, e.time)
            for e in server.state.scaling_events_by_job("default", "scaly")]


def _policies(server):
    return sorted((p.id, p.namespace, p.job_id, p.type,
                   sorted(p.target.items()), p.min, p.max,
                   sorted(p.policy.items()), p.enabled, p.create_index,
                   p.modify_index)
                  for p in server.state.scaling_policies())


SCALE_CASES = {
    # (scaling block, calls: (group, count, message, error))
    "up_and_down": ({"min": 1, "max": 10},
                    [("web", 5, "scale up", False),
                     ("web", 1, "scale down", False)]),
    "bounds": ({"min": 2, "max": 4},
               [("web", 1, "", False), ("web", 9, "", False),
                ("web", -1, "", False), ("web", 3, "in", False),
                ("nope", 3, "", False)]),
    "error_event_only": (None, [("web", None, "policy error", True),
                                ("web", 7, "errored", True),
                                ("web", None, "nothing", False)]),
    "no_block_unbounded": (None, [("web", 6, "", False)]),
}


@pytest.mark.parametrize("case", sorted(SCALE_CASES))
def test_scale_equals_the_reference(pair, case):
    ref, port = pair
    scaling, calls = SCALE_CASES[case]
    register_both(ref, port, _scaly(scaling), 130)
    for k, (group, count, message, error) in enumerate(calls):
        got, want = both(ref, port, lambda s, c: (lambda ev: ev and ev.id)(
            s.scale_job("default", "scaly", group, count=count,
                        message=message, error=error)), 140 + k)
        assert got == want, (case, k, got, want)
        _settle_evals(ref, port)
        assert_same(ref, port)
    assert _events(port) == _events(ref)
    assert _policies(port) == _policies(ref)
    assert port.job_scale_status("default", "scaly") == \
        ref.job_scale_status("default", "scaly")
    assert port.job_scale_status("default", "missing") is None


def test_scale_events_attributed_to_their_group(pair):
    ref, port = pair
    register_both(ref, port, _scaly(groups=2), 150)
    both(ref, port, lambda s, c: s.scale_job(
        "default", "scaly", "web", count=3, message="g1 up"), 151)
    _settle_evals(ref, port)
    status = port.job_scale_status("default", "scaly")
    assert status == ref.job_scale_status("default", "scaly")
    assert len(status["task_groups"]["web"]["events"]) == 1
    assert status["task_groups"]["group-1"]["events"] == []
    assert_same(ref, port)


def test_scaling_policies_follow_the_job(pair):
    """Derived from the scaling block on every register, dropped with
    the block, and dropped with the job and its events on delete."""
    ref, port = pair
    register_both(ref, port, _scaly({"min": 1, "max": 8,
                                     "policy": {"cooldown": "1m"}}), 160)
    assert _policies(port) == _policies(ref) and len(_policies(port)) == 1
    (pol,) = port.state.scaling_policies_by_job("default", "scaly")
    assert pol.target == {"Namespace": "default", "Job": "scaly",
                          "Group": "web"}
    assert port.state.scaling_policy_by_id(pol.id) is pol
    register_both(ref, port, _scaly(None), 161)
    assert _policies(port) == _policies(ref) == []
    register_both(ref, port, _scaly({"min": 1, "max": 8}), 162)
    both(ref, port, lambda s, c: s.scale_job(
        "default", "scaly", "web", count=None, message="x", error=True), 163)
    for server in (ref, port):
        server.state.delete_job("default", "scaly")
        assert server.state.scaling_policies() == []
        assert server.state.scaling_events_by_job("default", "scaly") == []
    assert port.state.table_index("scaling_policies") == \
        ref.state._table_index["scaling_policies"]
    _settle_evals(ref, port)
    assert_same(ref, port)


def test_scaling_events_keep_the_newest_twenty(pair):
    ref, port = pair
    register_both(ref, port, _scaly(), 170)
    for i in range(25):
        both(ref, port, lambda s, c: s.scale_job(
            "default", "scaly", "web", count=None, message=f"e{i}",
            error=True), 171)
    assert _events(port) == _events(ref)
    assert len(_events(port)) == 20 and _events(port)[-1][3] == "e24"
    assert port.state.latest_index() == ref.state.latest_index()


def test_malformed_scaling_is_refused_at_admission(pair):
    ref, port = pair
    for bad in ({"min": "abc"}, {"min": 5, "max": 2}, ["not", "a", "map"]):
        got, want = both(ref, port, lambda s, c: s.register_job(
            c(_scaly(bad))), 180)
        assert got[0] == want[0] == "ValueError", (bad, got, want)
        assert port.state.job_by_id("default", "scaly") is None
