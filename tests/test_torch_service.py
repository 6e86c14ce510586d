"""The struct half of the placement service, held against the JAX package
on the CPU: TpuPlacementService's pack and materialize, the solo dispatch
and the SolveBarrier hook, solve_system, and the LP tier's preemption
repair.

Tolerance: exact. Every lane table equals the reference's field by field
(dtype, shape and bits: order, const, init, batch, ptab, pinit); the same
solver result materializes to equal TpuPlacements (node, task resources,
reserved cores, device instance ids, ports, preempted allocs, score and
n_yielded to the bit); and end to end each world's plan through the port
equals the reference's tpu-binpack plan and the host oracle's placements.

The worlds are those of tests/test_solver_parity.py (every test function,
every seed), tests/test_system_tpu.py, tests/test_preemption.py and the
tiers of tests/test_parity_scale.py at tens of nodes. The reference runs
them through a Harness whose GenericScheduler takes a test-side solve
hook (``PortHook``): it carries the eval's snapshot, plan, job, task
group, places and nodes to the port (carry.store_from_reference,
carry.struct_from_reference), packs there and beside it in the
reference, solves the port's lane through a CPU SolveBarrier (or the
port's solo ``service.solve``), materializes, and carries the placements
back. System jobs go through the port's solve_system the same way.
"""
import dataclasses
import itertools
import random

import numpy as np
import pytest
import torch

import nomad_tpu.structs as ref_structs
from nomad_tpu import benchkit, mock
from nomad_tpu.scheduler import Harness
from nomad_tpu.scheduler.context import EvalContext as RefContext
from nomad_tpu.scheduler.factory import new_scheduler
from nomad_tpu.scheduler.reconcile import AllocPlaceResult as RefPlace
from nomad_tpu.solver import guard as ref_guard
from nomad_tpu.solver import service as ref_service
from nomad_tpu.solver.service import TpuPlacement as RefPlacement
from nomad_tpu.structs.job import reseed_ids
from nomad_tpu.structs import (
    AllocatedResources, AllocatedSharedResources,
    AllocatedTaskResources, Affinity, Constraint, DeviceRequest,
    NetworkResource, Plan as RefPlan, Port, PreemptionConfig,
    SchedulerConfiguration, Spread, ALLOC_CLIENT_RUNNING)
from nomad_tpu.tensor import pack as ref_pack

from nomad_tpu_torch.carry import store_from_reference, struct_from_reference
from nomad_tpu_torch.scheduler.context import EvalContext
from nomad_tpu_torch.solver import guard, lpq
from nomad_tpu_torch.solver.batch import SolveBarrier, make_solve_hook
from nomad_tpu_torch.solver.service import TpuPlacementService, dispatch_lane
from nomad_tpu_torch.tensor import pack as port_pack

from torch_sanitizers import armed

# the suite runs under the port's sanitizers (tests/torch_sanitizers.py)
_torch_sanitizers = armed("jitcheck")

# One intra-op thread: the port's CPU tensors are small, and the test
# run already keeps one xdist worker busy per core.
torch.set_num_threads(1)

REF_CLASSES = {name: cls for name, cls in vars(ref_structs).items()
               if isinstance(cls, type) and dataclasses.is_dataclass(cls)}
REF_CLASSES["AllocPlaceResult"] = RefPlace


@pytest.fixture(autouse=True)
def fresh_caches(monkeypatch):
    """Both packages' pack caches start empty, and every reference solve
    runs on the single-device program."""
    monkeypatch.setenv("NOMAD_TPU_MESH", "0")
    ref_pack._reset_pack_caches_for_tests()
    port_pack.reset_pack_caches()
    guard._reset_for_tests()
    ref_guard._reset_for_tests()
    lpq._reset_for_tests()
    yield
    guard._reset_for_tests()


# --------------------------------------------------------------------------
# field-by-field comparisons

def assert_lanes_equal(ref, port, skip=()):
    """``skip``: (tree, field) pairs left out of the comparison."""
    if ref is None or port is None:
        assert ref is None and port is None
        return
    assert np.array_equal(np.asarray(ref.order), np.asarray(port.order))
    assert ref.dtype_name == port.dtype_name
    assert bool(ref.spread_alg) == bool(port.spread_alg)
    for name in ("const", "init", "batch", "ptab", "pinit"):
        a, b = getattr(ref, name), getattr(port, name)
        if a is None or b is None:
            assert a is None and b is None, name
            continue
        assert type(a)._fields == type(b)._fields, name
        for f in type(a)._fields:
            if (name, f) in skip:
                continue
            x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
            assert x.dtype == y.dtype, (name, f, x.dtype, y.dtype)
            assert x.shape == y.shape, (name, f, x.shape, y.shape)
            assert np.array_equal(x, y), (name, f)
    assert ref.table_version == port.table_version
    assert ref.delta_src[1] == port.delta_src[1]
    assert [n.id for n in ref.nodes] == [n.id for n in port.nodes]
    if ref.cand_allocs is None:
        assert port.cand_allocs is None
    else:
        assert ([[a.id for a in c] for c in ref.cand_allocs]
                == [[a.id for a in c] for c in port.cand_allocs])


def _task_digest(tasks):
    if tasks is None:
        return None
    return tuple(sorted(
        (name, tr.cpu_shares, tr.memory_mb, tuple(tr.reserved_cores),
         tuple((d.vendor, d.type, d.name, tuple(d.device_ids))
               for d in tr.devices))
        for name, tr in tasks.items()))


def _shared_digest(shared):
    if shared is None:
        return None
    return (shared.disk_mb,
            tuple((p.label, p.value, p.to, p.host_ip) for p in shared.ports))


def placement_digest(p):
    score = np.float64(p.score)
    return (p.place.name, p.node.id if p.node is not None else None,
            _task_digest(p.task_resources),
            _shared_digest(p.alloc_resources), score.tobytes(),
            int(p.n_yielded),
            tuple(a.id for a in p.preempted_allocs)
            if p.preempted_allocs else None,
            p.resources_prebuilt is not None)


def assert_placements_equal(ref, port):
    assert ref is not None and port is not None
    assert [placement_digest(p) for p in ref] == \
        [placement_digest(p) for p in port]


# --------------------------------------------------------------------------
# the test-side solve hook

class PortHook:
    """Hands a reference scheduler's solves to the port. ``mode`` is
    "barrier" (pack, CPU SolveBarrier, materialize: make_solve_hook) or
    "solo" (the port's service.solve)."""

    def __init__(self, mode: str = "barrier"):
        self.mode = mode
        self._services = {}
        self.lanes = 0

    def port_of(self, service):
        """(port service, base memo) for a reference service: one port
        service per reference service, so the scan limit's stickiness
        carries across the eval's task groups."""
        ent = self._services.get(id(service))
        if ent is None:
            memo = {}
            store = store_from_reference(service.ctx.state, memo)
            pjob = struct_from_reference(service.job, memo)
            ctx = EvalContext(store.snapshot(), None)
            psvc = TpuPlacementService(
                ctx, pjob, service.batch_mode, service.spread_alg,
                preempt=service.preempt, device="cpu")
            ent = (service, psvc, memo)
            self._services[id(service)] = ent
        return ent[1], ent[2]

    def carry_in(self, service, *objs):
        """The port's service with the eval's current plan, and ``objs``
        carried."""
        psvc, memo = self.port_of(service)
        call_memo = dict(memo)
        psvc.ctx.plan = struct_from_reference(service.ctx.plan, call_memo)
        return psvc, [struct_from_reference(o, call_memo) for o in objs]

    @staticmethod
    def carry_back(service, placements, places, nodes):
        if placements is None:
            return None
        by_id = {n.id: n for n in nodes}
        memo = {}
        out = []
        for p, place in zip(placements, places):
            pre = None
            if p.preempted_allocs:
                pre = [service.ctx.state.alloc_by_id(a.id)
                       for a in p.preempted_allocs]
            out.append(RefPlacement(
                place, by_id[p.node.id] if p.node is not None else None,
                struct_from_reference(p.task_resources, memo, REF_CLASSES),
                struct_from_reference(p.alloc_resources, memo, REF_CLASSES),
                p.score, p.n_yielded, preempted_allocs=pre,
                resources_prebuilt=struct_from_reference(
                    p.resources_prebuilt, memo, REF_CLASSES)))
        return out

    def __call__(self, service, tg, places, nodes, penalties):
        psvc, (ptg, pplaces, pnodes, ppen) = self.carry_in(
            service, tg, places, nodes, penalties)
        ref_lane = service.pack(tg, places, nodes, penalties)
        lane = psvc.pack(ptg, pplaces, pnodes, ppen)
        assert_lanes_equal(ref_lane, lane)
        if lane is None:
            return None
        self.lanes += 1
        if self.mode == "solo":
            out = psvc.solve(ptg, pplaces, pnodes, ppen)
        else:
            # make_solve_hook's path, the barrier's result held aside:
            # the same solver result materializes equal in both packages
            captured = {}
            barrier = SolveBarrier(1, device="cpu")
            solve = barrier.solve

            def keep(lane_):
                captured["res"] = solve(lane_)
                return captured["res"]
            barrier.solve = keep
            out = make_solve_hook(barrier)(psvc, ptg, pplaces, pnodes, ppen)
            assert_placements_equal(
                service.materialize(ref_lane, *captured["res"]), out)
        return self.carry_back(service, out, places, nodes)

    def solve_system(self, service, tg, nodes, orig):
        psvc, (ptg, pnodes) = self.carry_in(service, tg, nodes)
        places = [RefPlace(name=f"{service.job.id}.{tg.name}[0]",
                           task_group=tg) for _ in nodes]
        pplaces = struct_from_reference(places, {id(tg): (tg, ptg)})
        assert_lanes_equal(service.pack(tg, places, nodes),
                           psvc.pack(ptg, pplaces, pnodes))
        want = orig(service, tg, nodes)
        got = psvc.solve_system(ptg, pnodes)
        assert_placements_equal(want, got)
        self.lanes += 1
        return self.carry_back(service, got, want and [p.place for p in want]
                               or [None] * len(got), nodes)


# --------------------------------------------------------------------------
# the worlds

def _random_fleet(rng, n):
    nodes = []
    for _ in range(n):
        node = mock.node()
        node.node_resources.cpu.cpu_shares = rng.choice([2000, 4000, 8000])
        node.node_resources.memory.memory_mb = rng.choice([4096, 8192,
                                                           16384])
        node.compute_class()
        nodes.append(node)
    return nodes


def _seed_usage(rng, h, nodes):
    for node in nodes:
        for _ in range(rng.randint(0, 3)):
            other = mock.job()
            other.task_groups[0].tasks[0].resources.cpu = rng.choice(
                [250, 500, 1000])
            other.task_groups[0].tasks[0].resources.memory_mb = rng.choice(
                [256, 512, 1024])
            a = mock.alloc_for(other, node)
            a.client_status = ALLOC_CLIENT_RUNNING
            h.state.upsert_allocs([a])


def _basic_job(rng):
    job = mock.job()
    job.task_groups[0].count = rng.randint(2, 8)
    job.task_groups[0].tasks[0].resources.cpu = rng.choice([250, 500, 1000])
    job.task_groups[0].tasks[0].resources.memory_mb = rng.choice([256, 512])
    return job


def _constraints_job(rng):
    job = _basic_job(rng)
    job.constraints = [Constraint(l_target="${attr.kernel.name}",
                                  r_target="linux", operand="=")]
    job.task_groups[0].constraints = [
        Constraint(l_target="${attr.cpu.numcores}", r_target="2",
                   operand=">=")]
    return job


def _affinity_job(rng):
    job = _basic_job(rng)
    job.affinities = [Affinity(l_target="${node.datacenter}",
                               r_target="dc1", operand="=", weight=50)]
    return job


def _spread_job(rng):
    job = _basic_job(rng)
    job.task_groups[0].spreads = [
        Spread(attribute="${node.datacenter}", weight=50)]
    return job


def _ports_job(rng):
    job = _basic_job(rng)
    job.task_groups[0].networks = [NetworkResource(
        reserved_ports=[Port(label="admin", value=8080)],
        dynamic_ports=[Port(label="http")])]
    return job


def _distinct_hosts_job(rng):
    job = _basic_job(rng)
    job.task_groups[0].count = 4
    job.task_groups[0].constraints = [Constraint(operand="distinct_hosts")]
    return job


def _job_distinct_hosts_two_tgs(rng):
    import copy
    job = _basic_job(rng)
    job.task_groups[0].count = 3
    tg2 = copy.deepcopy(job.task_groups[0])
    tg2.name = "api"
    tg2.count = 2
    job.task_groups.append(tg2)
    job.constraints = [Constraint(operand="distinct_hosts")]
    return job


def _sticky_limit_job(rng):
    """Two task groups: the first's spread raises the scan limit to 100,
    which sticks for the second."""
    import copy
    job = _basic_job(rng)
    job.task_groups[0].spreads = [
        Spread(attribute="${node.datacenter}", weight=50)]
    tg2 = copy.deepcopy(job.task_groups[0])
    tg2.name = "api"
    tg2.count = 3
    tg2.spreads = []
    job.task_groups.append(tg2)
    return job


def _distinct_property_job(rng):
    job = _basic_job(rng)
    job.task_groups[0].count = 4
    job.constraints = list(job.constraints) + [
        Constraint(l_target="${node.datacenter}",
                   r_target=str(rng.choice([2, 3])),
                   operand="distinct_property")]
    return job


def _distinct_property_tg_job(rng):
    job = _basic_job(rng)
    job.task_groups[0].count = 3
    job.task_groups[0].constraints = [
        Constraint(l_target="${attr.cpu.numcores}",
                   operand="distinct_property")]
    return job


def _devices_job(rng):
    job = _basic_job(rng)
    job.task_groups[0].count = rng.randint(2, 5)
    job.task_groups[0].tasks[0].resources.devices = [
        DeviceRequest(name="gpu", count=rng.choice([1, 2]))]
    return job


def _devices_fleet(rng, n):
    nodes = []
    for _ in range(n):
        node = (mock.gpu_node(count=rng.choice([2, 4]))
                if rng.random() < 0.7 else mock.node())
        node.node_resources.cpu.cpu_shares = rng.choice([4000, 8000])
        node.compute_class()
        nodes.append(node)
    return nodes


def _devices_affinity_job(rng):
    job = _basic_job(rng)
    job.task_groups[0].count = 3
    job.task_groups[0].tasks[0].resources.devices = [
        DeviceRequest(name="gpu", count=1, affinities=[
            Affinity(l_target="${device.attr.cuda_cores}",
                     r_target="3584", operand=">=", weight=50)])]
    return job


def _gpu_fleet(rng, n):
    return [mock.gpu_node(count=rng.choice([1, 2, 4])) for _ in range(n)]


def _cores_job(rng):
    job = mock.job()
    job.task_groups[0].count = 6
    job.task_groups[0].tasks[0].resources.cores = 2
    return job


def _cores_fleet(rng, n):
    nodes = []
    for _ in range(n):
        node = mock.node()
        k = rng.choice([2, 4, 8])
        node.node_resources.cpu.cpu_shares = k * 1000
        node.node_resources.cpu.total_core_count = k
        node.node_resources.cpu.reservable_cores = list(range(k))
        node.compute_class()
        nodes.append(node)
    return nodes


def _agent_reserved_fleet(rng, n):
    nodes = []
    for _ in range(n):
        node = mock.node()
        node.node_resources.cpu.cpu_shares = 4000
        node.node_resources.cpu.total_core_count = 4
        node.node_resources.cpu.reservable_cores = [0, 1, 2, 3]
        node.reserved_resources.cores = [0, 1]
        node.compute_class()
        nodes.append(node)
    return nodes


def _agent_reserved_job(rng):
    job = mock.job()
    job.task_groups[0].count = 4
    job.task_groups[0].tasks[0].resources.cores = 2
    return job


# name: (make_job, n_nodes, seeds, fleet_fn, seed_usage, host, tpu);
# the seeds are test_solver_parity.py's
PARITY_WORLDS = {
    "basic_service": (_basic_job, 12, range(6), None, True),
    "spread_algorithm": (_basic_job, 10, range(3), None, True,
                         "spread", "tpu-spread"),
    "with_constraints": (_constraints_job, 10, range(100, 103), None, True),
    "with_affinities": (_affinity_job, 8, range(200, 203), None, True),
    "with_spread_block": (_spread_job, 8, range(300, 303), None, True),
    "with_ports": (_ports_job, 8, range(400, 403), None, True),
    "distinct_hosts": (_distinct_hosts_job, 8, [77], None, True),
    "job_level_distinct_hosts": (_job_distinct_hosts_two_tgs, 8, [88],
                                 None, True),
    "large_fleet": (_basic_job, 200, [9], None, True),
    "distinct_property": (_distinct_property_job, 10, range(400, 403),
                          None, True),
    "distinct_property_tg_scope": (_distinct_property_tg_job, 10,
                                   range(500, 503), None, True),
    "devices": (_devices_job, 10, range(600, 603), _devices_fleet, True),
    "devices_with_affinities": (_devices_affinity_job, 8, range(700, 702),
                                _gpu_fleet, True),
    "reserved_cores": (_cores_job, 10, range(900, 903), _cores_fleet,
                       False),
    "cores_respect_agent_reserved": (_agent_reserved_job, 6, [4242],
                                     _agent_reserved_fleet, False),
    "sticky_limit_two_tgs": (_sticky_limit_job, 10, [31, 32], None, True),
}


def plan_digest(h, eval_id=None):
    """Every placement of the harness's plans: alloc name -> (node,
    task resources, shared resources, sorted names of the allocs it
    preempts)."""
    out = {}
    for plan in h.plans:
        by_preemptor = {}
        for allocs in plan.node_preemptions.values():
            for a in allocs:
                by_preemptor.setdefault(a.preempted_by_allocation,
                                        []).append(a.name)
        for node_id, allocs in plan.node_allocation.items():
            for a in allocs:
                if eval_id is not None and a.eval_id != eval_id:
                    continue
                ar = a.allocated_resources
                out[a.name] = (node_id, _task_digest(ar.tasks),
                               _shared_digest(ar.shared),
                               tuple(sorted(by_preemptor.get(a.id, ()))))
    return out


def _process(h, kind, ev, hook):
    if hook is None:
        return h.process(kind, ev)
    return h.process(lambda snap, planner: new_scheduler(
        kind, snap, planner, solve_hook=hook), ev)


def run_parity_world(name, seed, alg, hook=None):
    make_job, n_nodes, _seeds, fleet_fn, seed_usage = \
        PARITY_WORLDS[name][:5]
    reseed_ids(seed)
    rng = random.Random(seed)
    mock._counter = itertools.count()
    h = Harness()
    h.state.set_scheduler_config(
        SchedulerConfiguration(scheduler_algorithm=alg))
    nodes = (fleet_fn or _random_fleet)(rng, n_nodes)
    for i, node in enumerate(nodes):
        node.id = f"node-{seed}-{i:04d}"
        h.state.upsert_node(node)
    if seed_usage:
        _seed_usage(rng, h, nodes)
    job = make_job(rng)
    job.id = f"parity-job-{seed}"
    h.state.upsert_job(job)
    ev = mock.evaluation(job_id=job.id, type=job.type)
    ev.id = f"parity-eval-{seed:08d}"
    assert _process(h, "service" if job.type == "service" else job.type,
                    ev, hook) is None
    return plan_digest(h, ev.id)


def _triple(run, host_alg, tpu_alg, mode="barrier"):
    """(host oracle, reference tpu, port through the hook) digests."""
    host = run(host_alg, None)
    ref = run(tpu_alg, None)
    hook = PortHook(mode)
    port = run(tpu_alg, hook)
    return host, ref, port, hook


def _check_triple(host, ref, port, hook, full_host=False):
    assert ref, "no placements -- bad world"
    assert port == ref
    if full_host:
        assert host == ref
    else:
        assert ({k: v[0] for k, v in host.items()}
                == {k: v[0] for k, v in ref.items()})
    assert hook.lanes >= 1


PARITY_CASES = [(name, seed) for name, w in PARITY_WORLDS.items()
                for seed in w[2]]


@pytest.mark.parametrize("name,seed", PARITY_CASES,
                         ids=[f"{n}-{s}" for n, s in PARITY_CASES])
def test_parity_world_through_the_port(name, seed):
    w = PARITY_WORLDS[name]
    host_alg, tpu_alg = (w[5], w[6]) if len(w) > 5 else \
        ("binpack", "tpu-binpack")
    host, ref, port, hook = _triple(
        lambda alg, hk: run_parity_world(name, seed, alg, hk),
        host_alg, tpu_alg)
    _check_triple(host, ref, port, hook)


@pytest.mark.parametrize("name,seed", [("basic_service", 0),
                                       ("with_ports", 401),
                                       ("with_affinities", 200),
                                       ("devices", 600),
                                       ("reserved_cores", 901),
                                       ("distinct_property", 402)])
def test_parity_world_through_the_solo_dispatch(name, seed):
    host, ref, port, hook = _triple(
        lambda alg, hk: run_parity_world(name, seed, alg, hk),
        "binpack", "tpu-binpack", mode="solo")
    _check_triple(host, ref, port, hook)


def _cores_contention_run(alg, hook):
    import copy
    reseed_ids(7)
    rng = random.Random(7)
    mock._counter = itertools.count()
    h = Harness()
    h.state.set_scheduler_config(
        SchedulerConfiguration(scheduler_algorithm=alg))
    nodes = []
    for i in range(8):
        node = mock.node()
        k = rng.choice([4, 8])
        node.node_resources.cpu.cpu_shares = k * 1000
        node.node_resources.cpu.total_core_count = k
        node.node_resources.cpu.reservable_cores = list(range(k))
        node.compute_class()
        node.id = f"cores-node-{i:04d}"
        h.state.upsert_node(node)
        nodes.append(node)
    other = mock.job(id="core-holder")
    for i, node in enumerate(nodes):
        if i % 2:
            continue
        a = mock.alloc_for(other, node, index=i)
        mhz = node.node_resources.cpu.cpu_shares \
            // node.node_resources.cpu.total_core_count
        a.allocated_resources = AllocatedResources(
            tasks={"web": AllocatedTaskResources(
                cpu_shares=mhz * 2, memory_mb=256, reserved_cores=[0, 1])},
            shared=AllocatedSharedResources(disk_mb=150))
        a.client_status = ALLOC_CLIENT_RUNNING
        h.state.upsert_allocs([a])
    job = mock.job()
    tg = job.task_groups[0]
    tg.count = 5
    tg.tasks[0].resources.cores = 2
    extra = copy.deepcopy(tg.tasks[0])
    extra.name = "sidecar"
    extra.resources.cores = 0
    extra.resources.cpu = 300
    extra.resources.memory_mb = 128
    tg.tasks.append(extra)
    job.id = "cores-parity-job"
    h.state.upsert_job(job)
    ev = mock.evaluation(job_id=job.id, type=job.type)
    ev.id = "cores-parity-eval-0001"
    assert _process(h, "service", ev, hook) is None
    return plan_digest(h)


def test_parity_cores_with_contention_through_the_port():
    host, ref, port, hook = _triple(_cores_contention_run, "binpack",
                                    "tpu-binpack")
    _check_triple(host, ref, port, hook, full_host=True)
    assert any(v[1][1][3] for v in port.values())   # core ids granted


def _insufficient_run(alg, hook):
    reseed_ids(1)
    h = Harness()
    h.state.set_scheduler_config(
        SchedulerConfiguration(scheduler_algorithm=alg))
    n = mock.node()
    n.id = "small-node"
    n.node_resources.cpu.cpu_shares = 1000
    h.state.upsert_node(n)
    job = mock.job()
    job.id = "too-big"
    job.task_groups[0].count = 4
    h.state.upsert_job(job)
    ev = mock.evaluation(job_id=job.id, type="service")
    ev.id = "insufficient-eval-01"
    assert _process(h, "service", ev, hook) is None
    return plan_digest(h), len(h.create_evals)


def test_insufficient_capacity_blocks_through_the_port():
    (host, hb), (ref, rb), (port, pb), hook = _triple(
        _insufficient_run, "binpack", "tpu-binpack")
    assert len(port) == 2 and pb == rb == hb == 1
    assert port == ref and {k: v[0] for k, v in host.items()} == \
        {k: v[0] for k, v in ref.items()}


# -- system jobs (tests/test_system_tpu.py) ---------------------------------

def _system_run(seed, ports, alg, hook, monkeypatch):
    from nomad_tpu.structs import Evaluation
    if hook is not None:
        orig = ref_service.TpuPlacementService.solve_system
        monkeypatch.setattr(
            ref_service.TpuPlacementService, "solve_system",
            lambda self, tg, nodes: hook.solve_system(self, tg, nodes, orig))
    try:
        reseed_ids(seed)
        rng = random.Random(seed)
        mock._counter = itertools.count()
        h = Harness()
        h.state.set_scheduler_config(SchedulerConfiguration(
            scheduler_algorithm=alg,
            preemption_config=PreemptionConfig(
                system_scheduler_enabled=False)))
        for i in range(30):
            node = mock.node()
            node.id = f"sys-node-{i:04d}"
            node.node_resources.cpu.cpu_shares = rng.choice([600, 2000,
                                                             4000])
            node.node_resources.memory.memory_mb = rng.choice([512, 4096,
                                                               8192])
            node.compute_class()
            h.state.upsert_node(node)
            for _ in range(rng.randint(0, 2)):
                other = mock.job()
                other.task_groups[0].tasks[0].resources.cpu = 400
                other.task_groups[0].tasks[0].resources.memory_mb = 400
                a = mock.alloc_for(other, node)
                a.client_status = ALLOC_CLIENT_RUNNING
                h.state.upsert_allocs([a])
        job = mock.system_job()
        job.id = "sys-parity"
        tg = job.task_groups[0]
        tg.tasks[0].resources.cpu = 500
        tg.tasks[0].resources.memory_mb = 512
        if ports:
            tg.networks = [NetworkResource(
                dynamic_ports=[Port(label="http")],
                reserved_ports=[Port(label="adm", value=9800)])]
        h.state.upsert_job(job)
        ev = Evaluation(id=f"sys-parity-eval-{seed:08d}",
                        namespace=job.namespace, job_id=job.id,
                        priority=job.priority, type=job.type,
                        triggered_by="job-register", status="pending")
        assert h.process("system", ev) is None
        return {v[0]: v[1:] for v in plan_digest(h).values()}
    finally:
        monkeypatch.undo()


@pytest.mark.parametrize("seed,ports", [(0, False), (1, False), (2, False),
                                        (77, True)])
def test_system_world_through_the_port(seed, ports, monkeypatch):
    host = _system_run(seed, ports, "binpack", None, monkeypatch)
    ref = _system_run(seed, ports, "tpu-binpack", None, monkeypatch)
    hook = PortHook()
    port = _system_run(seed, ports, "tpu-binpack", hook, monkeypatch)
    assert ref and port == ref and set(host) == set(ref)
    assert hook.lanes == 1
    if ports:
        assert {k: v[1] for k, v in host.items()} == \
            {k: v[1] for k, v in port.items()}


# -- the tiers of tests/test_parity_scale.py, at tens of nodes --------------

def _tier_run(tier, n_nodes, count, seed, alg, hook):
    reseed_ids(seed)
    rng = random.Random(seed)
    mock._counter = itertools.count()
    h = Harness()
    cfg = SchedulerConfiguration(scheduler_algorithm=alg)
    if tier == 5:
        cfg.preemption_config = PreemptionConfig(
            service_scheduler_enabled=True, batch_scheduler_enabled=True)
    h.state.set_scheduler_config(cfg)
    nodes = benchkit.make_fleet(rng, h, n_nodes, gpus=(tier == 5))
    if tier == 5:
        benchkit.seed_utilization(rng, h, nodes, 0.95,
                                  priorities=(10, 20, 30, 40))
    elif tier in (3, 4):
        benchkit.seed_utilization(rng, h, nodes, 0.25)
    job = benchkit.tier_job(tier, rng, count)
    job.id = f"tier{tier}-job-{seed}"
    if tier == 5:
        job.priority = 70
        job.task_groups[0].tasks[0].resources.cpu = 1000
        job.task_groups[0].tasks[0].resources.devices = [
            DeviceRequest(name="nvidia/gpu", count=1)]
    h.state.upsert_job(job)
    ev = mock.evaluation(job_id=job.id, type=job.type, priority=job.priority)
    ev.id = f"tier{tier}-eval-{seed:08d}"
    kind = job.type if job.type in ("service", "batch") else "service"
    assert _process(h, kind, ev, hook) is None
    return plan_digest(h, ev.id)


TIER_CASES = [(1, 5, 3, 0), (1, 5, 3, 1), (2, 40, 30, 0), (2, 40, 30, 1),
              (3, 40, 30, 100), (3, 40, 30, 101), (4, 40, 30, 200),
              (4, 40, 30, 201), (5, 24, 12, 42)]


@pytest.mark.parametrize("tier,n_nodes,count,seed", TIER_CASES)
def test_tier_world_through_the_port(tier, n_nodes, count, seed):
    host, ref, port, hook = _triple(
        lambda alg, hk: _tier_run(tier, n_nodes, count, seed, alg, hk),
        "binpack", "tpu-binpack")
    _check_triple(host, ref, port, hook)
    if tier == 5:
        assert any(v[3] for v in port.values())     # it preempted


def test_tier2_spread_variant_through_the_port():
    host, ref, port, hook = _triple(
        lambda alg, hk: _tier_run(2, 40, 30, 11, alg, hk),
        "spread", "tpu-spread")
    _check_triple(host, ref, port, hook)


# -- preemption worlds (tests/test_preemption.py) ---------------------------

def _fill_node(h, node, cpu_each, count, priority):
    allocs = []
    for i in range(count):
        j = mock.job(priority=priority)
        j.task_groups[0].tasks[0].resources.cpu = cpu_each
        j.task_groups[0].tasks[0].resources.memory_mb = 512
        h.state.upsert_job(j)
        a = mock.alloc_for(j, node, i)
        a.client_status = ALLOC_CLIENT_RUNNING
        allocs.append(a)
    h.state.upsert_allocs(allocs)
    return allocs


def _preempt_run(case, alg, hook):
    reseed_ids(len(case))
    mock._counter = itertools.count()
    h = Harness()
    h.state.set_scheduler_config(SchedulerConfiguration(
        scheduler_algorithm=alg,
        preemption_config=PreemptionConfig(
            system_scheduler_enabled=True, batch_scheduler_enabled=True,
            service_scheduler_enabled=True)))
    node = mock.node()
    node.id = "preempt-node-0"
    h.state.upsert_node(node)
    cpu, mem = 2000, 512
    if case == "lower_priority":
        _fill_node(h, node, 1800, 2, 20)
    elif case == "within_delta":
        _fill_node(h, node, 1800, 2, 65)
    elif case == "minimal_set":
        _fill_node(h, node, 2000, 1, 20)
        _fill_node(h, node, 900, 2, 30)
        mem = 256
    job = mock.job(priority=70)
    job.id = f"preempt-{case}"
    job.task_groups[0].count = 1
    job.task_groups[0].tasks[0].resources.cpu = cpu
    job.task_groups[0].tasks[0].resources.memory_mb = mem
    h.state.upsert_job(job)
    ev = mock.evaluation(job_id=job.id, type=job.type, priority=job.priority)
    ev.id = f"preempt-eval-{case}"
    assert _process(h, "service", ev, hook) is None
    return plan_digest(h, ev.id), len(h.create_evals)


@pytest.mark.parametrize("case", ["lower_priority", "within_delta",
                                  "minimal_set"])
def test_preemption_world_through_the_port(case):
    (host, hb), (ref, rb), (port, pb), hook = _triple(
        lambda alg, hk: _preempt_run(case, alg, hk), "binpack",
        "tpu-binpack")
    assert port == ref and pb == rb
    assert {k: (v[0], v[3]) for k, v in host.items()} == \
        {k: (v[0], v[3]) for k, v in ref.items()}
    assert hook.lanes == 1
    if case == "within_delta":
        assert not port and pb == 1
    else:
        assert len(port) == 1 and list(port.values())[0][3]


# -- pieces of the pack --------------------------------------------------------

def _ref_world(seed=5, n=12, ports=True, plan_deltas=True):
    """A reference store with port-holding allocs, a snapshot, and an
    eval context whose plan stops, preempts and places."""
    rng = random.Random(seed)
    mock._counter = itertools.count()
    h = Harness()
    nodes = _random_fleet(rng, n)
    for i, node in enumerate(nodes):
        node.id = f"piece-node-{i:04d}"
        if i % 3 == 0:
            node.reserved_resources.reserved_ports = [22, 20001]
        h.state.upsert_node(node)
    _seed_usage(rng, h, nodes)
    job = mock.job(id="piece-job")
    job.task_groups[0].count = 4
    if ports:
        job.task_groups[0].networks = [NetworkResource(
            reserved_ports=[Port(label="admin", value=8080)],
            dynamic_ports=[Port(label="http")])]
    h.state.upsert_job(job)
    existing = []
    for i, node in enumerate(nodes[:6]):
        a = mock.alloc_for(job, node, index=i)
        a.client_status = ALLOC_CLIENT_RUNNING
        a.allocated_resources.shared.ports = [
            ref_structs.AllocatedPortMapping(label="http", value=20000 + i,
                                             host_ip="192.168.0.100")]
        existing.append(a)
    h.state.upsert_allocs(existing)
    snap = h.state.snapshot()
    plan = RefPlan(eval_id="piece-eval-000001", job=job, priority=50)
    if plan_deltas:
        plan.append_stopped_alloc(existing[0], "stop")
        other = snap.allocs_by_node(nodes[7].id)
        if other:
            plan.append_preempted_alloc(other[0], "x")
        new = mock.alloc_for(job, nodes[8], index=9)
        new.allocated_resources.shared.ports = [
            ref_structs.AllocatedPortMapping(label="http", value=20005,
                                             host_ip="192.168.0.100")]
        plan.append_alloc(new)
    ctx = RefContext(snap, plan)
    return h, snap, ctx, job, snap.ready_nodes_in_pool("default")


def _carry_world(snap, ctx, job, nodes):
    memo = {}
    store = store_from_reference(snap, memo)
    pctx = EvalContext(store.snapshot(),
                       struct_from_reference(ctx.plan, memo))
    return (pctx, struct_from_reference(job, memo),
            struct_from_reference(nodes, memo), store)


@pytest.mark.parametrize("ports", [True, False])
def test_incremental_usage_equals_the_reference_table_path(ports):
    """The port's incremental path (base fold + this job's counts + plan
    deltas), the route when the alloc table cannot serve, gives the
    usage the reference's table path gives, port bitmap included."""
    h, snap, ctx, job, nodes = _ref_world(ports=ports)
    rsvc = ref_service.TpuPlacementService(ctx, job, False, False,
                                           dtype="float64")
    tg = job.task_groups[0]
    matrix = ref_pack.pack_nodes(nodes)
    assert snap.alloc_table is not None
    want = rsvc._pack_usage_from_table(snap.alloc_table, matrix, nodes, tg)

    pctx, pjob, pnodes, _ = _carry_world(snap, ctx, job, nodes)
    psvc = TpuPlacementService(pctx, pjob, False, False, device="cpu")
    pmatrix = port_pack.pack_nodes(pnodes)
    got = psvc._pack_usage_incremental(pmatrix, pnodes, pjob.task_groups[0])
    for f in ("used_cpu", "used_mem", "used_disk", "placed_jobtg",
              "placed_job", "dyn_used"):
        x, y = getattr(want, f), getattr(got, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    if want.port_bitmap is None:
        assert got.port_bitmap is None
    else:
        assert np.array_equal(want.port_bitmap, got.port_bitmap)
    # the incremental usage equals the plain per-node fold, too (a
    # portless task group packs no port state)
    prop = {n.id: pctx.proposed_allocs(n.id) for n in pnodes}
    plain = port_pack.pack_usage(pmatrix, prop, pjob.id, "web",
                                 pjob.namespace, pnodes)
    for f in ("used_cpu", "used_mem", "used_disk", "placed_jobtg",
              "placed_job") + (("dyn_used", "port_bitmap") if ports
                               else ()):
        assert np.array_equal(getattr(plain, f), getattr(got, f)), f


def test_usage_base_catches_up_through_the_journal():
    """A second snapshot after an alloc write: the port's usage base
    advances by the journal's deltas (a delta hit, no refold) and equals
    a fresh fold of the new snapshot."""
    from nomad_tpu_torch import mock as pmock
    from nomad_tpu_torch.state.store import StateStore
    from nomad_tpu_torch.structs import Plan

    store = StateStore()
    nodes = [pmock.node(id=f"cu-{i}") for i in range(6)]
    for n in nodes:
        store.upsert_node(n)
    job = pmock.job(id="cu-job")
    store.upsert_job(job)
    store.upsert_allocs([pmock.alloc_for(job, nodes[i % 6], index=i)
                         for i in range(4)])
    tg = job.task_groups[0]

    def usage():
        snap = store.snapshot()
        ctx = EvalContext(snap, Plan(eval_id="cu-eval-0001", job=job))
        svc = TpuPlacementService(ctx, job, False, False, device="cpu")
        ready = snap.ready_nodes_in_pool("default")
        matrix = port_pack.pack_nodes_cached(
            ready, snap.node_table_index, snap.nodes_pack_key(ready))
        return svc._pack_usage_incremental(matrix, ready, tg), matrix, \
            ready, snap

    u1, m1, _, _ = usage()
    store.upsert_allocs([pmock.alloc_for(job, nodes[5], index=7)])
    u2, m2, ready, snap = usage()
    assert m1 is m2
    st = port_pack.pack_cache_stats()
    assert st["usage_base_misses"] == 1 and st["usage_base_delta_hits"] == 1
    fresh = port_pack.fold_usage_base(
        m2, ready, lambda nid: snap.allocs_by_node(nid))
    assert np.array_equal(fresh["used_cpu"], u2.used_cpu)
    assert u2.used_cpu[5] - u1.used_cpu[5] == 500


@pytest.mark.parametrize("batch_mode", [False, True])
def test_limit_batch_mode_and_stickiness(batch_mode):
    """The scan limit across two task groups: log2 (or batch mode's 2),
    the spread / affinity override, and its stickiness for the task
    groups after it."""
    h, snap, ctx, job, nodes = _ref_world(ports=False, plan_deltas=False)
    rsvc = ref_service.TpuPlacementService(ctx, job, batch_mode, False,
                                           dtype="float64")
    pctx, pjob, pnodes, _ = _carry_world(snap, ctx, job, nodes)
    psvc = TpuPlacementService(pctx, pjob, batch_mode, False, device="cpu")
    tg = job.task_groups[0]
    ptg = pjob.task_groups[0]
    seq = [(40, False, False), (40, True, False), (40, False, False),
           (12, False, True), (3, False, False)]
    for n, aff, spr in seq:
        assert (rsvc._limit(n, tg, aff, spr)
                == psvc._limit(n, ptg, aff, spr))
    assert psvc._current_limit == 100


def test_pack_cache_counts_hits_per_eval():
    """Two evals on one snapshot share the matrix and its memos: the
    second eval's pack is all hits, as in the reference."""
    h, snap, ctx, job, nodes = _ref_world(ports=False, plan_deltas=False)
    pctx, pjob, pnodes, store = _carry_world(snap, ctx, job, nodes)
    ptg = pjob.task_groups[0]
    from nomad_tpu_torch.scheduler.reconcile import AllocPlaceResult
    from nomad_tpu_torch.structs import Plan
    places = [AllocPlaceResult(name=f"piece-job.web[{i}]", task_group=ptg)
              for i in range(3)]
    psnap = store.snapshot()
    ready = psnap.ready_nodes_in_pool("default")
    for k, want_hits in ((0, False), (1, True)):
        c = EvalContext(psnap, Plan(eval_id=f"cache-eval-{k:04d}",
                                    job=pjob))
        svc = TpuPlacementService(c, pjob, False, False, device="cpu")
        assert svc.pack(ptg, places, ready) is not None
        ms, hits, misses = svc.last_pack
        assert ms > 0
        assert (misses == 0) == want_hits and (hits > 0) == want_hits
    st = port_pack.pack_cache_stats()
    assert st["matrix_hits"] == 1 and st["matrix_misses"] == 1


def test_breaker_edges_drop_the_pack_caches():
    """A breaker edge (trip or recovery) drops the cached node matrices
    with their memos, as the reference guard drops its pack caches."""
    from nomad_tpu_torch import mock as pmock
    from nomad_tpu_torch.state.store import StateStore

    store = StateStore()
    for i in range(5):
        store.upsert_node(pmock.node(id=f"edge-{i}"))
    snap = store.snapshot()
    ready = snap.ready_nodes_in_pool("default")
    m = port_pack.pack_nodes_cached(ready, snap.node_table_index,
                                    snap.nodes_pack_key(ready))
    assert port_pack.pack_nodes_cached(
        ready, snap.node_table_index, snap.nodes_pack_key(ready)) is m
    assert port_pack.pack_cache_stats()["matrix_entries"] == 1
    guard._invalidate_pack_layer("breaker trip")
    st = port_pack.pack_cache_stats()
    assert st["matrix_entries"] == 0 and st["invalidations"] == 1
    assert port_pack.pack_nodes_cached(
        ready, snap.node_table_index, snap.nodes_pack_key(ready)) is not m


# -- the alloc table's scheduler half -----------------------------------------
# The worlds of tests/test_verify_fold.py (the table-fold fuzz: prior
# allocs, plan-committed stops awaiting acks, client-terminal allocs, an
# in-eval stop), tests/test_pack_cache.py (stored ports, a plan that
# stops and places) and tests/test_pack_delta.py (mixed churn: batch and
# scalar writes, client-terminal transitions, deletions), each built in
# the reference's store and carried to the port's.

def _verify_fold_world(seed):
    from nomad_tpu.structs import PlanResult as RefPlanResult
    rng = random.Random(seed * 613 + 3)
    h = Harness()
    nodes = []
    for i in range(20):
        n = mock.node()
        n.id = f"up-n{i:03d}"
        n.node_resources.cpu.cpu_shares = rng.choice([2000, 4000])
        n.compute_class()
        h.state.upsert_node(n)
        nodes.append(n)
    jobs = []
    for k in range(3):
        j = mock.job(id=f"up-j{k}")
        h.state.upsert_job(j)
        jobs.append(j)
    prior = []
    for _ in range(30):
        a = mock.alloc_for(rng.choice(jobs), rng.choice(nodes))
        a.client_status = rng.choice(
            ["running", "running", "running", "complete"])
        prior.append(a)
    h.state.upsert_allocs(prior)
    live_prior = [a for a in prior if a.client_status == "running"]
    stop_plan = RefPlan(eval_id="f" * 36, priority=50, job=jobs[0])
    for a in rng.sample(live_prior, 6):
        stop_plan.append_stopped_alloc(a, "churn")
    h.state.upsert_plan_results(
        RefPlanResult(node_update=stop_plan.node_update,
                      node_allocation={}, node_preemptions={}), [])
    job = jobs[1]
    job.task_groups[0].count = 10
    plan = RefPlan(eval_id="a" * 36, priority=50, job=job)
    stopped = {s.id for al in stop_plan.node_update.values() for s in al}
    victims = [a for a in live_prior if a.id not in stopped]
    if victims:
        plan.append_stopped_alloc(rng.choice(victims), "in-eval")
    return h, job, plan


def _pack_cache_world(seed):
    import copy
    h = Harness()
    nodes = []
    for i in range(8):
        n = mock.node()
        n.id = f"pc-node-{i:04d}"
        n.compute_class()
        nodes.append(n)
        h.state.upsert_node(n)
    for k in range(5):
        j = mock.job(id=f"pc-filler-{k}")
        h.state.upsert_job(j)
        a = mock.alloc_for(j, nodes[k % 8])
        a.client_status = "running"
        h.state.upsert_allocs([a])
    j = mock.job(id="pc-ports")
    h.state.upsert_job(j)
    a_ports = mock.alloc_for(j, nodes[2])
    a_ports.client_status = "running"
    a_ports.allocated_resources.shared.ports = [
        ref_structs.AllocatedPortMapping(label="http", value=20123,
                                         host_ip="10.0.0.2")]
    h.state.upsert_allocs([a_ports])
    job = mock.job(id=f"pc-job-{seed}")
    job.task_groups[0].count = 4
    if seed % 2:
        job.task_groups[0].networks = [NetworkResource(
            dynamic_ports=[Port(label="http")])]
    h.state.upsert_job(job)
    snap = h.state.snapshot()
    plan = RefPlan(eval_id=f"pc-eval-{seed:029d}", priority=50, job=job)
    stored = [a for a in snap.allocs() if not a.client_terminal_status()][0]
    stop = copy.copy(stored)
    stop.desired_status = "stop"
    plan.node_update.setdefault(stored.node_id, []).append(stop)
    placed = mock.alloc_for(mock.job(id="pc-placed"), nodes[5])
    plan.node_allocation.setdefault(nodes[5].id, []).append(placed)
    return h, job, plan


def _pack_delta_world(seed):
    rng = random.Random(seed + 7)
    h = Harness()
    nodes = []
    for i in range(8):
        n = mock.node()
        n.id = f"pd-node-{i:04d}"
        n.compute_class()
        h.state.upsert_node(n)
        nodes.append(n)
    all_allocs = []
    for j in range(6):
        job = mock.job(id=f"pd-job-{j}")
        h.state.upsert_job(job)
        allocs = []
        for _ in range(12):
            a = mock.alloc_for(job, nodes[rng.randrange(len(nodes))])
            a.client_status = "running"
            allocs.append(a)
        if j % 2:
            h.state.upsert_allocs(allocs)
        else:
            for a in allocs:
                h.state.upsert_allocs([a])
        all_allocs.extend(allocs)
    for a in [a for i, a in enumerate(all_allocs) if i % 3 == 0]:
        upd = a.copy_skip_job()
        upd.client_status = "complete"
        h.state.update_allocs_from_client([upd])
    h.state.delete_allocs([a.id for i, a in enumerate(all_allocs)
                           if i % 6 == 1])
    job = h.state.job_by_id("default", "pd-job-2")
    job.task_groups[0].count = 6
    return h, job, RefPlan(eval_id=f"pd-eval-{seed:030d}", priority=50,
                           job=job)


TABLE_WORLDS = ([("verify_fold", s) for s in range(3)]
                + [("pack_cache", s) for s in range(2)]
                + [("pack_delta", 0)])
_TABLE_BUILDERS = {"verify_fold": _verify_fold_world,
                   "pack_cache": _pack_cache_world,
                   "pack_delta": _pack_delta_world}
SWITCHES = {"cached": ("1", "1"), "wholesale": ("1", "0"),
            "uncached": ("0", "1")}


def _set_switches(monkeypatch, name):
    cache, delta = SWITCHES[name]
    for prefix in ("NOMAD_TPU_", "NOMAD_TPU_TORCH_"):
        monkeypatch.setenv(prefix + "PACK_CACHE", cache)
        monkeypatch.setenv(prefix + "PACK_DELTA", delta)


def _usage_fields(u):
    return {f: getattr(u, f) for f in (
        "used_cpu", "used_mem", "used_disk", "placed_jobtg", "placed_job",
        "dyn_used", "port_bitmap")}


def assert_usage_equal(want, got):
    for f, x in _usage_fields(want).items():
        y = getattr(got, f)
        if x is None:
            assert y is None, f
        else:
            assert x.dtype == y.dtype and np.array_equal(x, y), f


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("switches", list(SWITCHES))
@pytest.mark.parametrize("world,seed", TABLE_WORLDS,
                         ids=[f"{w}-{s}" for w, s in TABLE_WORLDS])
def test_table_path_lanes_equal_the_reference(world, seed, switches, dtype,
                                              monkeypatch):
    """The port's _pack_inner on a carried store takes the reference's
    usage route (the table, unless PACK_CACHE=0 hides nothing: the table
    still serves) and packs equal lanes field by field; the table path's
    usage equals the port's incremental path's and the plain walk's; the
    lanes solve to the same choices (scores within rtol 1e-12 in
    float64, 1e-6 in float32) and materialize to equal placements."""
    _set_switches(monkeypatch, switches)
    h, job, plan = _TABLE_BUILDERS[world](seed)
    snap = h.state.snapshot()
    nodes = snap.ready_nodes_in_pool("default")
    tg = job.task_groups[0]
    places = [RefPlace(name=f"{job.id}.{tg.name}[{k}]", task_group=tg)
              for k in range(tg.count)]
    rsvc = ref_service.TpuPlacementService(RefContext(snap, plan), job,
                                           False, False, dtype=dtype)
    ref_lane = rsvc.pack(tg, places, nodes)

    memo = {}
    store = store_from_reference(snap, memo)
    pjob = struct_from_reference(job, memo)
    pctx = EvalContext(store.snapshot(), struct_from_reference(plan, memo))
    ptg = pjob.task_groups[0]
    pplaces = struct_from_reference(places, memo)
    pnodes = struct_from_reference(nodes, memo)
    psvc = TpuPlacementService(pctx, pjob, False, False, dtype=dtype,
                               device="cpu")
    lane = psvc.pack(ptg, pplaces, pnodes)
    assert_lanes_equal(ref_lane, lane)
    assert float(np.asarray(lane.init.used_cpu).sum()) > 0

    # the three routes' usage agree on this snapshot and plan
    matrix = lane.matrix
    table = pctx.state.alloc_table
    via_table = psvc._pack_usage_from_table(table, matrix, pnodes, ptg)
    via_inc = psvc._pack_usage_incremental(matrix, pnodes, ptg)
    assert_usage_equal(via_table, via_inc)
    assert_usage_equal(via_table, psvc._pack_usage_from_table(
        table, matrix, pnodes, ptg))        # a fold-cache hit, if portless
    prop = {n.id: pctx.proposed_allocs(n.id) for n in pnodes}
    plain = port_pack.pack_usage(matrix, prop, pjob.id, ptg.name,
                                 pjob.namespace, pnodes)
    for f in ("used_cpu", "used_mem", "used_disk", "placed_jobtg",
              "placed_job"):
        assert np.array_equal(getattr(plain, f), getattr(via_table, f)), f
    assert table.fold_parity_mismatch() == 0

    want = ref_service.dispatch_lane(ref_lane)
    got = dispatch_lane(lane, device="cpu")
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(np.asarray(got[2]), np.asarray(want[2]))
    np.testing.assert_allclose(
        np.asarray(got[1], dtype=np.float64),
        np.asarray(want[1], dtype=np.float64),
        rtol=1e-12 if dtype == "float64" else 1e-6)
    ref_out = rsvc.materialize(ref_lane, *want)
    port_out = psvc.materialize(lane, *got)
    assert [(p.place.name, p.node and p.node.id) for p in ref_out] == \
        [(p.place.name, p.node and p.node.id) for p in port_out]


def test_port_overflow_and_walks_skip_the_table(monkeypatch):
    """An alloc holding more ports than a table row holds sends the pack
    to the incremental route, in both packages. A portless task group's
    incremental base packs no port state in the port (as the table path
    packs it) where the reference's folds the stored allocs' ports: the
    lanes differ in dyn_avail alone, on the nodes holding ports, which a
    task group asking no dynamic port never reads -- the solves agree."""
    h, job, plan = _pack_cache_world(0)
    nodes = h.state.snapshot().ready_nodes_in_pool("default")
    j = mock.job(id="pc-overflow")
    h.state.upsert_job(j)
    a = mock.alloc_for(j, nodes[3])
    a.client_status = "running"
    a.allocated_resources.shared.ports = [
        ref_structs.AllocatedPortMapping(label=f"p{i}", value=21000 + i)
        for i in range(10)]
    h.state.upsert_allocs([a])
    snap = h.state.snapshot()
    assert snap.alloc_table.has_port_overflow
    tg = job.task_groups[0]
    places = [RefPlace(name=f"{job.id}.{tg.name}[{k}]", task_group=tg)
              for k in range(tg.count)]
    rsvc = ref_service.TpuPlacementService(RefContext(snap, plan), job,
                                           False, False, dtype="float64")
    memo = {}
    store = store_from_reference(snap, memo)
    pctx = EvalContext(store.snapshot(), struct_from_reference(plan, memo))
    assert pctx.state.alloc_table.has_port_overflow
    pjob = struct_from_reference(job, memo)
    psvc = TpuPlacementService(pctx, pjob, False, False, device="cpu")
    calls = []
    real = TpuPlacementService._pack_usage_from_table
    monkeypatch.setattr(TpuPlacementService, "_pack_usage_from_table",
                        lambda *a: calls.append(1) or real(*a))
    ref_lane = rsvc.pack(tg, places, nodes)
    lane = psvc.pack(pjob.task_groups[0], struct_from_reference(places, memo),
                     struct_from_reference(nodes, memo))
    assert not calls
    assert_lanes_equal(ref_lane, lane, skip={("init", "dyn_avail")})
    differ = np.nonzero(np.asarray(ref_lane.init.dyn_avail)
                        != np.asarray(lane.init.dyn_avail))[0]
    port_nodes = {a.node_id for a in snap.allocs()
                  if a.allocated_resources.all_ports()}
    order = np.asarray(lane.order)
    assert differ.size and {nodes[order[i]].id for i in differ} <= port_nodes
    want = ref_service.dispatch_lane(ref_lane)
    got = dispatch_lane(lane, device="cpu")
    for x, y in zip(got, want):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
