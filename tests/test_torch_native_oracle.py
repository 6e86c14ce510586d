"""The compiled host-baseline oracle (nomad_tpu_torch/scheduler/
native_oracle.py over csrc/pack_kernels.cc nt_solve_eval) against the
port's host stack (GenericStack.select, placement by placement) and the
reference's oracle: the worlds of tests/test_native_oracle.py, each
built in both packages from their own mock with the id streams seeded
alike, the same decisions placement for placement."""
from types import SimpleNamespace

import pytest

from nomad_tpu import mock as ref_mock
from nomad_tpu import structs as ref_structs
from nomad_tpu.scheduler import Harness as RefHarness
from nomad_tpu.scheduler import native_oracle as ref_oracle
from nomad_tpu.scheduler.context import EvalContext as RefEvalContext
from nomad_tpu.structs.job import reseed_ids as ref_reseed_ids

from nomad_tpu_torch import mock as port_mock
from nomad_tpu_torch import structs as port_structs
from nomad_tpu_torch.scheduler import native_oracle as port_oracle
from nomad_tpu_torch.scheduler.context import EvalContext
from nomad_tpu_torch.scheduler.harness import Harness
from nomad_tpu_torch.scheduler.stack import GenericStack, SelectOptions

from test_torch_native import ensure_reference_native

EVAL_ID = "native-parity-eval-00000001"
SEED = 9090

REF = SimpleNamespace(mock=ref_mock, st=ref_structs, Harness=RefHarness,
                      Ctx=RefEvalContext, oracle=ref_oracle,
                      reseed=ref_reseed_ids)
PORT = SimpleNamespace(mock=port_mock, st=port_structs, Harness=Harness,
                       Ctx=EvalContext, oracle=port_oracle,
                       reseed=port_structs.reseed_ids)


@pytest.fixture(autouse=True)
def _reference_library():
    ensure_reference_native()


def build_world(P, n_nodes, hetero=True, ineligible_every=0):
    """(reference test_native_oracle.py:28) A fleet of 2,000 / 4,000 /
    8,000 MHz nodes; every k-th node loses its driver."""
    P.reseed(SEED)
    h = P.Harness()
    nodes = []
    for i in range(n_nodes):
        n = P.mock.node()
        n.id = f"npo-node-{i:05d}"
        if hetero:
            n.node_resources.cpu.cpu_shares = (2000, 4000, 8000)[i % 3]
            n.node_resources.memory.memory_mb = (4096, 8192, 16384)[i % 3]
        if ineligible_every and i % ineligible_every == 0:
            del n.attributes["driver.mock"]
        n.compute_class()
        nodes.append(n)
        h.state.upsert_node(n)
    return h, nodes


def host_stack(h, job, nodes, n_placements, cfg=None):
    """The port's host stack, one select a placement, each placed alloc
    appended to the plan (the usage the next select sees)."""
    st = port_structs
    plan = st.Plan(eval_id=EVAL_ID, priority=50, job=job)
    ctx = EvalContext(h.state.snapshot(), plan)
    stack = GenericStack(False, ctx)
    if cfg is not None:
        stack.set_scheduler_configuration(cfg)
    stack.set_job(job)
    stack.set_nodes(list(nodes))
    tg = job.task_groups[0]
    placed = {}
    for i in range(n_placements):
        name = f"{job.id}.{tg.name}[{i}]"
        option = stack.select(tg, SelectOptions(alloc_name=name))
        if option is None:
            placed[i] = None
            continue
        plan.append_alloc(st.Allocation(
            id=st.generate_uuid(), name=name, job_id=job.id, job=job,
            task_group=tg.name, node_id=option.node.id,
            allocated_resources=st.AllocatedResources(
                tasks=dict(option.task_resources),
                shared=st.AllocatedSharedResources(
                    disk_mb=tg.ephemeral_disk.size_mb))))
        placed[i] = option.node.id
    return placed


def oracle(P, h, job, nodes, n_placements, spread=False):
    tg = job.task_groups[0]
    assert P.oracle.supported(tg)
    snap = h.state.snapshot()
    ctx = P.Ctx(snap, P.st.Plan(eval_id=EVAL_ID, priority=50, job=job))
    world = P.oracle.PackedWorld(nodes, ctx, job, tg)
    return P.oracle.solve(world, EVAL_ID, snap.latest_index(), n_placements,
                          tg.count, spread_alg=spread)


def make_job(P, count, cpu=None, job_id="npo-job"):
    job = P.mock.job(id=job_id)
    job.task_groups[0].count = count
    if cpu is not None:
        job.task_groups[0].tasks[0].resources.cpu = cpu
    return job


def fresh(P, n_nodes, count, **kw):
    h, nodes = build_world(P, n_nodes, **kw)
    job = make_job(P, count)
    h.state.upsert_job(job)
    return h, nodes, job


def partially_used(P):
    """(reference :101) Another job's allocs on every third node, the
    job's own on every seventh: usage carried and anti-affinity."""
    h, nodes = build_world(P, 120)
    job = make_job(P, 8)
    other = make_job(P, 1, job_id="npo-other")
    h.state.upsert_job(job)
    allocs = []
    for i, n in enumerate(nodes):
        if i % 3 == 0:
            allocs.append(P.mock.alloc_for(other, n, index=i))
        if i % 7 == 0:
            allocs.append(P.mock.alloc_for(job, n, index=i))
    h.state.upsert_allocs(allocs)
    return h, nodes, job


CASES = {
    # name: (the world's maker, placements, spread)
    "fresh_heterogeneous_fleet": (lambda P: fresh(P, 240, 60), 60, False),
    "partially_used_world_and_antiaffinity": (partially_used, 40, False),
    "ineligible_nodes_filtered": (
        lambda P: fresh(P, 150, 30, ineligible_every=4), 30, False),
    "spread_algorithm": (lambda P: fresh(P, 160, 50), 50, True),
    "bench_shape": (lambda P: fresh(P, 1000, 300), 300, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_oracle_decisions(case):
    """The oracle places as the port's host stack does, and as the
    reference's oracle on the reference's world."""
    build, n_placements, spread = CASES[case]
    cfg = (port_structs.SchedulerConfiguration(
        scheduler_algorithm=port_structs.SCHED_ALG_SPREAD)
        if spread else None)
    h, nodes, job = build(PORT)
    want = host_stack(h, job, nodes, n_placements, cfg=cfg)
    h, nodes, job = build(PORT)
    got = oracle(PORT, h, job, nodes, n_placements, spread=spread)
    rh, rnodes, rjob = build(REF)
    ref = oracle(REF, rh, rjob, rnodes, n_placements, spread=spread)
    assert got == want
    assert got == ref
    assert sum(v is not None for v in got.values()) > n_placements // 2


def test_exhaustion_yields_unplaced():
    h, nodes = build_world(PORT, 8, hetero=False)
    job = make_job(PORT, 200, cpu=1900)
    h.state.upsert_job(job)
    want = host_stack(h, job, nodes, 40)
    got = oracle(PORT, h, job, nodes, 40)
    assert got == want
    assert None in got.values()     # the fleet really was exhausted


def test_unsupported_asks_are_refused():
    job = port_mock.job()
    tg = job.task_groups[0]
    assert port_oracle.supported(tg)
    tg.tasks[0].resources.cores = 2
    assert not port_oracle.supported(tg)
    assert port_oracle.scan_limit(1000, False) == 10
    assert port_oracle.scan_limit(1000, True) == 2
