"""The port's structs, state store and host helpers, held against the JAX
package's on the CPU.

Tolerance: exact. Carried structs equal their source field by field
(``dataclasses.asdict``) and keep shared objects shared; compute_class
hashes the same bytes; the port store reaches the reference store's
index after the same writes and lists allocs in the same order; port
assignment, allocs_fit, comparable(), the DeviceAllocator,
select_reserved_cores and the Preemptor give the reference's answers
(ids, ports, dimensions, eviction sets) on mock worlds.
"""
import dataclasses
import itertools
import random

import pytest

import nomad_tpu.structs as ref_structs
from nomad_tpu import mock
from nomad_tpu.scheduler import preemption as ref_preemption
from nomad_tpu.scheduler import rank as ref_rank
from nomad_tpu.scheduler.context import EvalContext as RefContext
from nomad_tpu.state.store import StateStore as RefStore
from nomad_tpu.structs import (
    Affinity, AllocatedDeviceResource, AllocatedPortMapping,
    AllocatedResources, AllocatedSharedResources, AllocatedTaskResources,
    Constraint, DeviceRequest, NetworkResource, Plan as RefPlan, Port,
    SchedulerConfiguration, ALLOC_CLIENT_COMPLETE, ALLOC_CLIENT_RUNNING)
from nomad_tpu.structs.job import reseed_ids

from nomad_tpu_torch import mock as port_mock
from nomad_tpu_torch import structs as port_structs
from nomad_tpu_torch.carry import store_from_reference, struct_from_reference
from nomad_tpu_torch.scheduler import preemption, rank
from nomad_tpu_torch.scheduler.context import EvalContext
from nomad_tpu_torch.scheduler.feasible import check_constraint
from nomad_tpu_torch.state.store import StateStore


def _asdict(obj):
    return dataclasses.asdict(obj)


# -- carrying -----------------------------------------------------------------

def _world(seed=0, n=6):
    reseed_ids(seed)
    rng = random.Random(seed)
    mock._counter = itertools.count()
    h = RefStore()
    h.set_scheduler_config(SchedulerConfiguration(
        scheduler_algorithm="tpu-binpack"))
    nodes = []
    for i in range(n):
        node = (mock.gpu_node(count=rng.choice([2, 4])) if i % 2
                else mock.node())
        node.id = f"carry-node-{i}"
        node.meta["rack"] = f"r{i % 3}"
        node.reserved_resources.reserved_ports = [22] if i % 3 == 0 else []
        node.compute_class()
        h.upsert_node(node)
        nodes.append(node)
    jobs = []
    for k in range(3):
        j = mock.job(priority=rng.choice([20, 50, 70]))
        j.id = f"carry-job-{k}"
        j.constraints = [Constraint(l_target="${meta.rack}",
                                    r_target="r1", operand="!=")]
        j.affinities = [Affinity(l_target="${node.datacenter}",
                                 r_target="dc1", weight=40)]
        j.task_groups[0].networks = [NetworkResource(
            dynamic_ports=[Port(label="http")])]
        h.upsert_job(j)
        jobs.append(j)
    allocs = []
    for i, node in enumerate(nodes):
        for k in range(rng.randint(1, 3)):
            a = mock.alloc_for(jobs[k], node, index=i * 10 + k)
            a.client_status = rng.choice([ALLOC_CLIENT_RUNNING,
                                          ALLOC_CLIENT_COMPLETE])
            a.allocated_resources.shared.ports = [AllocatedPortMapping(
                label="http", value=20000 + k, host_ip="192.168.0.100")]
            allocs.append(a)
    h.upsert_allocs(allocs[: len(allocs) // 2])
    h.upsert_allocs(allocs[len(allocs) // 2:])
    # a replacement keeps its place in the per-node order
    h.upsert_allocs([dataclasses.replace(allocs[0])])
    return h, nodes, jobs, allocs


def test_struct_from_reference_round_trips_and_keeps_sharing():
    h, nodes, jobs, allocs = _world()
    memo = {}
    pallocs = struct_from_reference(allocs, memo)
    for a, p in zip(allocs, pallocs):
        assert type(p).__module__.startswith("nomad_tpu_torch.structs")
        assert _asdict(a) == _asdict(p)
    # allocs of one job share its Job, carried once
    by_job = {}
    for a, p in zip(allocs, pallocs):
        by_job.setdefault(id(a.job), set()).add(id(p.job))
    assert all(len(v) == 1 for v in by_job.values())
    assert pallocs[0].job is struct_from_reference(allocs[0].job, memo)
    # and back: the reference's classes give the source again
    ref_classes = {name: cls for name, cls in vars(ref_structs).items()
                   if isinstance(cls, type)
                   and dataclasses.is_dataclass(cls)}
    back = struct_from_reference(pallocs, {}, ref_classes)
    for a, b in zip(allocs, back):
        assert type(b) is type(a) and _asdict(a) == _asdict(b)
    # a shared AllocatedResources stays shared
    res = AllocatedResources(tasks={"t": AllocatedTaskResources(
        cpu_shares=1, memory_mb=2)})
    pair = struct_from_reference([res, res, res.tasks])
    assert pair[0] is pair[1] and pair[2] is pair[0].tasks
    with pytest.raises(TypeError):
        struct_from_reference(object())


def test_compute_class_is_equal():
    h, nodes, _, _ = _world(seed=3, n=8)
    for node in nodes:
        p = struct_from_reference(node)
        p.computed_class = ""
        assert p.compute_class() == node.compute_class()
    n = port_mock.node()
    n.attributes["unique.hostname"] = "x"
    n.meta["unique.serial"] = "y"
    r = struct_from_reference(n, classes={
        name: cls for name, cls in vars(ref_structs).items()
        if isinstance(cls, type) and dataclasses.is_dataclass(cls)})
    assert r.compute_class() == n.compute_class()


def test_store_reaches_the_reference_index_after_the_same_writes():
    reseed_ids(11)
    ref, port = RefStore(), StateStore()
    nodes = [mock.node() for _ in range(4)]
    job = mock.job()
    cfg = SchedulerConfiguration(scheduler_algorithm="tpu-binpack")
    steps = [("set_scheduler_config", cfg)]
    steps += [("upsert_node", n) for n in nodes]
    steps += [("upsert_job", job)]
    allocs = [mock.alloc_for(job, nodes[i % 4], index=i) for i in range(6)]
    steps += [("upsert_allocs", allocs[:3]), ("upsert_allocs", allocs[3:])]
    memo = {}
    for name, arg in steps:
        i = getattr(ref, name)(arg)
        j = getattr(port, name)(struct_from_reference(arg, memo))
        assert i == j
    assert port.latest_index() == ref.latest_index()
    assert port.table_index("nodes") == ref.table_index("nodes")
    ps, rs = port.snapshot(), ref.snapshot()
    assert ps.node_table_index == rs.node_table_index
    assert ps.latest_index() == rs.latest_index()
    assert ps._store is port
    for n in nodes:
        assert ([a.id for a in ps.allocs_by_node(n.id)]
                == [a.id for a in rs.allocs_by_node(n.id)])
    assert ([a.id for a in ps.allocs_by_job(job.namespace, job.id)]
            == [a.id for a in rs.allocs_by_job(job.namespace, job.id)])
    assert ([n.id for n in ps.ready_nodes_in_pool("default")]
            == [n.id for n in rs.ready_nodes_in_pool("default")])
    ready = ps.ready_nodes_in_pool("default")
    assert ps.nodes_pack_key(ready) == tuple(n.id for n in ready)
    assert ps.nodes_pack_key(list(ready)) is None
    # a snapshot is cached per index and immutable under later writes
    assert port.snapshot() is ps
    port.upsert_node(struct_from_reference(mock.node(), memo))
    assert port.snapshot() is not ps
    assert len(ps.nodes()) == 4


def test_store_from_reference_keeps_order_and_index():
    h, nodes, jobs, allocs = _world(seed=5)
    snap = h.snapshot()
    store = store_from_reference(snap)
    ps = store.snapshot()
    assert ps.latest_index() == snap.latest_index()
    assert ps.node_table_index == snap.node_table_index
    assert [n.id for n in ps.nodes()] == [n.id for n in snap.nodes()]
    for n in nodes:
        assert ([a.id for a in ps.allocs_by_node(n.id)]
                == [a.id for a in snap.allocs_by_node(n.id)])
    for j in jobs:
        assert ([a.id for a in ps.allocs_by_job(j.namespace, j.id)]
                == [a.id for a in snap.allocs_by_job(j.namespace, j.id)])
    assert _asdict(ps.scheduler_config()) == \
        _asdict(snap.scheduler_config())
    # the journal starts empty at the snapshot's index
    assert store.alloc_deltas_since(snap.latest_index()) == (True, [])
    assert store.alloc_deltas_since(snap.latest_index() - 1)[0] is False


# -- ports, fit, comparable ---------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_network_index_assigns_the_same_ports(seed):
    h, nodes, jobs, allocs = _world(seed=seed)
    ask = [NetworkResource(
        reserved_ports=[Port(label="admin", value=8080)],
        dynamic_ports=[Port(label="http"), Port(label="rpc")])]
    memo = {}
    for node in nodes:
        ref_idx = ref_structs.NetworkIndex()
        ref_idx.set_node(node)
        on_node = [a for a in allocs if a.node_id == node.id]
        rc = ref_idx.add_allocs(on_node)
        port_idx = port_structs.NetworkIndex()
        port_idx.set_node(struct_from_reference(node, memo))
        pc = port_idx.add_allocs(struct_from_reference(on_node, memo))
        assert rc == pc
        for _ in range(3):
            r, rerr = ref_idx.assign_ports(ask)
            p, perr = port_idx.assign_ports(struct_from_reference(ask, memo))
            assert rerr == perr
            if r is None:       # the static port is taken from then on
                assert p is None
                continue
            assert _asdict(r) == _asdict(p)
            for pm in r.ports:
                ref_idx.add_reserved_port(pm.value)
                port_idx.add_reserved_port(pm.value)


@pytest.mark.parametrize("seed", range(4))
def test_allocs_fit_and_comparable_are_equal(seed):
    h, nodes, jobs, allocs = _world(seed=seed)
    memo = {}
    for node in nodes:
        on_node = [a for a in allocs if a.node_id == node.id]
        # over-ask the node now and then
        extra = mock.alloc_for(jobs[0], node, index=99)
        extra.allocated_resources.tasks["web"].cpu_shares = 3000 + 500 * seed
        extra.allocated_resources.tasks["web"].reserved_cores = [1, 2]
        for group in (on_node, on_node + [extra]):
            r = ref_structs.allocs_fit(node, group, check_devices=True)
            p = port_structs.allocs_fit(struct_from_reference(node, memo),
                                        struct_from_reference(group, memo),
                                        check_devices=True)
            assert r[:2] == p[:2] and _asdict(r[2]) == _asdict(p[2])
        for a in on_node:
            assert _asdict(a.allocated_resources.comparable()) == _asdict(
                struct_from_reference(a, memo).allocated_resources
                .comparable())
            assert a.allocated_resources.all_ports() == \
                struct_from_reference(a, memo).allocated_resources \
                .all_ports()


# -- devices and cores --------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_device_allocator_assigns_the_same_instances(seed):
    reseed_ids(seed)
    rng = random.Random(seed)
    node = mock.gpu_node(count=4)
    node.node_resources.devices.append(ref_structs.NodeDeviceResource(
        vendor="amd", type="gpu", name="mi100",
        instance_ids=[f"amd-{k}" for k in range(3)],
        attributes={"memory": 32 * 1024, "cuda_cores": 0}))
    job = mock.job()
    holder = mock.alloc_for(job, node)
    holder.allocated_resources.tasks["web"].devices = [
        AllocatedDeviceResource(
            vendor="nvidia", type="gpu", name="1080ti",
            device_ids=node.node_resources.devices[0].instance_ids[:1])]
    reqs = [DeviceRequest(name="gpu", count=rng.choice([1, 2])),
            DeviceRequest(name="nvidia/gpu", count=1, affinities=[
                Affinity(l_target="${device.attr.cuda_cores}",
                         r_target="3584", operand=">=", weight=50)]),
            DeviceRequest(name="gpu", count=3, affinities=[
                Affinity(l_target="${device.model}", r_target="mi100",
                         weight=-30)])]
    plan = RefPlan(eval_id="dev-eval")
    ref_alloc = ref_rank.DeviceAllocator(RefContext(RefStore(), plan), node)
    ref_alloc.add_allocs([holder])
    memo = {}
    port_alloc = rank.DeviceAllocator(
        EvalContext(StateStore(), struct_from_reference(plan, memo)),
        struct_from_reference(node, memo))
    port_alloc.add_allocs([struct_from_reference(holder, memo)])
    for req in reqs * 2:
        r = ref_alloc.assign_device(req)
        p = port_alloc.assign_device(struct_from_reference(req, memo))
        assert (r[0] is None) == (p[0] is None) and r[1:] == p[1:]
        if r[0] is not None:
            assert _asdict(r[0]) == _asdict(p[0])
            ref_alloc.add_reserved(r[0])
            port_alloc.add_reserved(p[0])
    assert ref_alloc.used == port_alloc.used
    # a request with device constraints: the reference's assign_device
    # raises AttributeError there (its checker shim lacks the target
    # resolver); the port checks the constraint
    pick = rank.DeviceAllocator(port_alloc.ctx, port_alloc.node)
    offer, _, err = pick.assign_device(port_structs.DeviceRequest(
        name="gpu", count=1, constraints=[port_structs.Constraint(
            l_target="${device.vendor}", r_target="amd")]))
    assert offer.vendor == "amd" and offer.device_ids == ["amd-0"]


@pytest.mark.parametrize("consumed,count", [((), 2), ((0,), 2), ((0, 1), 3),
                                            ((2, 3), 1), ((), 8)])
def test_select_reserved_cores_is_equal(consumed, count):
    node = mock.node()
    node.node_resources.cpu.total_core_count = 6
    node.node_resources.cpu.reservable_cores = [0, 1, 2, 3, 4, 5]
    node.reserved_resources.cores = [4]
    p = struct_from_reference(node)
    assert (ref_rank.select_reserved_cores(node, set(consumed), count)
            == rank.select_reserved_cores(p, set(consumed), count))


def test_check_constraint_operands_are_equal():
    from nomad_tpu.scheduler.feasible import check_constraint as ref_check
    cases = [("=", "a", "a"), ("!=", "a", "b"), ("<", "2", "10"),
             (">=", "b", "a"), ("version", "1.2.3", ">= 1.2, < 2.0"),
             ("semver", "1.3.0-beta", ">= 1.2"), ("regexp", "linux-5",
                                                  "^linux"),
             ("set_contains", "a,b,c", "a,c"),
             ("set_contains_any", "a,b", "c,b"), ("is_set", "x", ""),
             ("is_not_set", "", ""), ("distinct_hosts", "", "")]
    rctx = RefContext(RefStore(), RefPlan())
    pctx = EvalContext(StateStore(), port_structs.Plan())
    for op, lv, rv in cases:
        for lf, rf in ((True, True), (False, True), (True, False)):
            assert ref_check(rctx, op, lv, rv, lf, rf) == \
                check_constraint(pctx, op, lv, rv, lf, rf), (op, lf, rf)


# -- the Preemptor (the cases of tests/test_preemption.py) --------------------

def _fill(node, cpu_each, count, priority, gpus=0):
    out = []
    for i in range(count):
        j = mock.job(priority=priority)
        j.task_groups[0].tasks[0].resources.cpu = cpu_each
        j.task_groups[0].tasks[0].resources.memory_mb = 512
        a = mock.alloc_for(j, node, i)
        a.client_status = ALLOC_CLIENT_RUNNING
        if gpus:
            a.allocated_resources.tasks["web"].devices = [
                AllocatedDeviceResource(
                    vendor="nvidia", type="gpu", name="1080ti",
                    device_ids=node.node_resources.devices[0]
                    .instance_ids[:gpus])]
        out.append(a)
    return out


def _ask(cpu, mem=512):
    return AllocatedResources(
        tasks={"web": AllocatedTaskResources(cpu_shares=cpu,
                                             memory_mb=mem)},
        shared=AllocatedSharedResources(disk_mb=150))


PREEMPT_CASES = {
    # name: (job priority, fill spec, ask cpu, ask mem)
    "lower_priority": (70, [(1800, 2, 20)], 2000, 512),
    "within_priority_delta": (70, [(1800, 2, 65)], 2000, 512),
    "minimal_set": (70, [(2000, 1, 20), (900, 2, 30)], 2000, 256),
    "system_full_node": (90, [(1800, 2, 20)], 3000, 1024),
    "mixed_priorities": (80, [(700, 2, 10), (900, 2, 40), (400, 1, 75)],
                         2600, 2048),
}


@pytest.mark.parametrize("case", sorted(PREEMPT_CASES))
def test_preemptor_picks_the_same_evictions(case):
    reseed_ids(len(case))
    prio, fills, cpu, mem = PREEMPT_CASES[case]
    node = mock.node()
    cands = [a for spec in fills for a in _fill(node, *spec)]
    own = mock.job(priority=prio)
    own_alloc = mock.alloc_for(own, node)
    cands.append(own_alloc)
    memo = {}
    pnode = struct_from_reference(node, memo)
    pcands = struct_from_reference(cands, memo)
    for already in ([], cands[:1]):
        ref_p = ref_preemption.Preemptor(prio, None, (own.namespace, own.id))
        ref_p.set_node(node)
        ref_p.set_preemptions(already)
        ref_p.set_candidates(cands)
        port_p = preemption.Preemptor(prio, None, (own.namespace, own.id))
        port_p.set_node(pnode)
        port_p.set_preemptions(struct_from_reference(already, memo))
        port_p.set_candidates(pcands)
        want = ref_p.preempt_for_task_group(_ask(cpu, mem))
        got = port_p.preempt_for_task_group(
            struct_from_reference(_ask(cpu, mem), memo))
        assert [a.id for a in want] == [a.id for a in got]
    if case == "within_priority_delta":
        assert not want
    else:
        assert want


def test_preemptor_device_and_network_paths_are_equal():
    reseed_ids(21)
    node = mock.gpu_node(count=2)
    holders = _fill(node, 500, 1, 20, gpus=2)
    port_holder = _fill(node, 500, 1, 30)[0]
    port_holder.allocated_resources.shared.ports = [AllocatedPortMapping(
        label="admin", value=8080, host_ip="192.168.0.100")]
    cands = holders + [port_holder]
    own = mock.job(priority=70)
    memo = {}
    ref_p = ref_preemption.Preemptor(70, None, (own.namespace, own.id))
    ref_p.set_node(node)
    ref_p.set_candidates(cands)
    port_p = preemption.Preemptor(70, None, (own.namespace, own.id))
    port_p.set_node(struct_from_reference(node, memo))
    port_p.set_candidates(struct_from_reference(cands, memo))
    req = DeviceRequest(name="gpu", count=1)
    want = ref_p.preempt_for_device(req, None)
    got = port_p.preempt_for_device(struct_from_reference(req, memo), None)
    assert want and [a.id for a in want] == [a.id for a in got]
    ask = NetworkResource(reserved_ports=[Port(label="admin", value=8080)])
    want = ref_p.preempt_for_network(ask, None)
    got = port_p.preempt_for_network(struct_from_reference(ask, memo), None)
    assert want and [a.id for a in want] == [a.id for a in got]
