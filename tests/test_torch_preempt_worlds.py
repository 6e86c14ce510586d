"""Preemption lanes packed by the reference from real scheduler worlds,
solved by both packages.

Lanes come from nomad_tpu's TpuPlacementService.pack with preemption on
(nomad_tpu.mock nodes and jobs in a Harness state store): the tier-5
shapes of tests/test_preemption_tpu.py (a fleet at 95% cpu fill from
priority 10-40 jobs, a priority-70 job that must evict to place) and
tests/test_tier5_devices.py (the same with GPU nodes and a one-GPU ask).
Carried across with lane_from_reference(ptab=, pinit=), they must give,
through the port's fuse_and_solve on the CPU, the same chosen, n_yielded
and eviction rows as the reference's fuse_and_solve, scores within
rtol=1e-12 (float64), and take the same kernel: a uniform lane (GPU or
not) the windowed one, a lane whose candidates have a max_parallel limit
the dense one. The port's pack_lane_arrays rebuilds the reference's
preemption tables from node-axis arrays in original node order.
"""
import itertools
import random

import numpy as np
import pytest
import torch

from nomad_tpu import mock
from nomad_tpu.scheduler import Harness
from nomad_tpu.scheduler.context import EvalContext
from nomad_tpu.scheduler.reconcile import AllocPlaceResult
from nomad_tpu.solver import binpack as ref
from nomad_tpu.solver import guard
from nomad_tpu.solver.batch import fuse_and_solve as ref_fuse_and_solve
from nomad_tpu.solver.service import TpuPlacementService
from nomad_tpu.structs import (
    ALLOC_CLIENT_RUNNING, DeviceRequest, MigrateStrategy, NodeDeviceResource,
    Plan)

from nomad_tpu_torch.carry import lane_from_reference
from nomad_tpu_torch.solver import preempt
from nomad_tpu_torch.solver.batch import fuse_and_solve, fuse_lanes
from nomad_tpu_torch.solver.service import (
    evictions, pack_lane_arrays, placements)
from nomad_tpu_torch.tensor.pack import (
    DeviceInfo, NodeMatrix, PreemptInfo, UsageState)

# One intra-op thread: the port's CPU tensors are small, and the test
# run already keeps one xdist worker busy per core.
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def clean_guard():
    guard._reset_for_tests()
    yield
    guard._reset_for_tests()


def _fill(rng, h, nodes, *, cpu=900, tiers=(10, 20, 30, 40),
          max_parallel=None, per_job=1):
    """Fill every node to ~95% of its cpu with running low-priority
    allocs (test_preemption_tpu._tiered_world); with ``max_parallel``
    the fillers come ``per_job`` to a job, dealt round-robin so a node's
    fillers belong to different jobs, whose task group migrates that
    many at a time."""
    slots = [(node, used) for node in nodes
             for used in range(0, int(node.node_resources.cpu.cpu_shares
                                      * 0.95) - cpu + 1, cpu)]
    n_jobs = -(-len(slots) // per_job)
    jobs = {}
    for k, (node, used) in enumerate(slots):
        j = k % n_jobs
        if j not in jobs:
            job = mock.job(priority=rng.choice(tiers))
            job.id = f"filler-{node.id}-{used}"
            job.task_groups[0].tasks[0].resources.cpu = cpu
            job.task_groups[0].tasks[0].resources.memory_mb = rng.choice(
                [512, 1024])
            if max_parallel is not None:
                job.task_groups[0].migrate = MigrateStrategy(
                    max_parallel=max_parallel)
            h.state.upsert_job(job)
            jobs[j] = job
        a = mock.alloc_for(jobs[j], node)
        a.client_status = ALLOC_CLIENT_RUNNING
        h.state.upsert_allocs([a])


def _world(seed, n_nodes, *, gpus=False, **fill):
    rng = random.Random(seed)
    mock._counter = itertools.count()
    h = Harness()
    nodes = []
    for i in range(n_nodes):
        node = mock.node()
        node.id = f"pw-node-{i:04d}"
        node.node_resources.cpu.cpu_shares = (4000 if not gpus
                                              else rng.choice([4000, 8000]))
        node.node_resources.memory.memory_mb = 8192
        if gpus and i % 2 == 0:
            node.node_resources.devices = [NodeDeviceResource(
                vendor="nvidia", type="gpu", name="v100",
                instance_ids=[f"{node.id}-g{k}"
                              for k in range(rng.choice([2, 4]))])]
        node.compute_class()
        h.state.upsert_node(node)
        nodes.append(node)
    _fill(rng, h, nodes, **fill)
    return h, nodes


def _pack(h, nodes, count, *, gpu=False, job_id="preempt-job", seed=0):
    job = mock.job(priority=70)
    job.id = job_id
    tg = job.task_groups[0]
    tg.count = count
    tg.tasks[0].resources.cpu = 1000
    tg.tasks[0].resources.memory_mb = 512
    if gpu:
        tg.tasks[0].resources.devices = [DeviceRequest(name="nvidia/gpu",
                                                       count=1)]
    h.state.upsert_job(job)
    plan = Plan(eval_id=f"{job_id}-eval-{seed:016d}", priority=70, job=job)
    ctx = EvalContext(h.state.snapshot(), plan)
    places = [AllocPlaceResult(name=f"{job.id}.{tg.name}[{k}]",
                               task_group=tg) for k in range(count)]
    svc = TpuPlacementService(ctx, job, batch_mode=False, spread_alg=False,
                              preempt=True)
    lane = svc.pack(tg, places, nodes)
    assert lane is not None and lane.ptab is not None
    return lane


def _carry(lane, dtype_name=None):
    return lane_from_reference(lane.const, lane.init, lane.batch, lane.order,
                               dtype_name=dtype_name or lane.dtype_name,
                               spread_alg=lane.spread_alg,
                               node_ids=lane.matrix.node_ids,
                               ptab=lane.ptab, pinit=lane.pinit,
                               device="cpu")


def _assert_same(want, got):
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert len(w) == len(g) == 4
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[2], w[2])
        np.testing.assert_array_equal(g[3], w[3])
        np.testing.assert_allclose(g[1], w[1], rtol=1e-12)


@pytest.fixture(scope="module")
def tier5():
    """Tier-5 shape: 120 nodes at 95% cpu from priority 10-40 fillers;
    three priority-70 evals of 1000-MHz placements (the windowed
    kind), and one more world whose fillers come ten to a job with
    max_parallel 1 (the dense kind)."""
    h, nodes = _world(7, 120)
    lanes = [_pack(h, nodes, c, job_id=f"preempt-job-{k}", seed=k)
             for k, c in enumerate((16, 24, 9))]
    hd, nodes_d = _world(8, 120, max_parallel=1, per_job=10)
    dense = [_pack(hd, nodes_d, 20, job_id="preempt-dense", seed=9)]
    return lanes, dense, nodes


def test_tier5_lanes_match_reference_and_route_windowed(tier5):
    lanes, dense, _ = tier5
    assert all(l.wavefront_ok() for l in lanes)
    assert not dense[0].wavefront_ok()
    ports = [_carry(l) for l in lanes + dense]
    assert [p.wavefront_ok() for p in ports] == [True] * 3 + [False]
    groups = fuse_lanes(ports)
    assert sorted((g.wave, len(g.idxs)) for g in groups) == [(False, 1),
                                                             (True, 3)]
    want = ref_fuse_and_solve(lanes + dense)
    got = fuse_and_solve(ports, device="cpu")
    _assert_same(want, got)
    for (chosen, _, _, rows), lane in zip(got, lanes + dense):
        placed = chosen >= 0
        assert placed.all()
        # at 95% fill a 1000-MHz ask needs an eviction on every node
        assert rows[placed].any(axis=1).all()


def test_max_parallel_lane_routes_dense_and_the_penalty_bites(tier5):
    """The dense lane's fillers share max_parallel-1 jobs, a node's
    fillers in different jobs: once one of a job's allocs is evicted,
    its siblings carry the penalty, and the eviction rows differ from
    the same lane's without the limit."""
    _, dense, _ = tier5
    port = _carry(dense[0])
    chosen, _, _, rows = fuse_and_solve([port], device="cpu")[0]
    assert int((chosen >= 0).sum()) == 20 and rows.any(axis=1).all()
    port.ptab = port.ptab._replace(maxp=np.zeros_like(port.ptab.maxp))
    port._wave = None
    assert port.wavefront_ok()
    free = fuse_and_solve([port], device="cpu")[0]
    assert not np.array_equal(free[3], rows)


def test_evictions_map_back_to_the_reference_candidates(tier5):
    """evictions() names, per placement, the chosen node and the
    candidate columns it evicts there: the reference's candidate allocs
    at those columns are on that node, of a lower tier, and none is
    evicted twice."""
    lanes, _, nodes = tier5
    lane = lanes[0]
    port = _carry(lane)
    chosen, _, _, rows = fuse_and_solve([port], device="cpu")[0]
    seen = set()
    idx, ids = placements(port, chosen)
    for k, (node_idx, cols) in enumerate(evictions(port, chosen, rows)):
        assert node_idx == idx[k] >= 0 and len(cols) >= 1
        node = nodes[node_idx]
        assert ids[k] == node.id
        cands = lane.cand_allocs[int(chosen[k])]
        for c in cols:
            alloc = cands[c]
            assert alloc.node_id == node.id
            assert alloc.job.priority <= 60
            assert alloc.id not in seen
            seen.add(alloc.id)
    (none_idx, none_cols), = evictions(port, np.array([-1]),
                                       np.zeros((1, 16), bool))
    assert none_idx == -1 and none_cols.size == 0


def test_float32_lanes_match_reference(tier5):
    """The same packed lanes in float32, through the reference's own
    float32 programs (dense and windowed) and the port's plain versions:
    decisions and eviction rows exactly, scores to the bit."""
    lanes, dense, _ = tier5

    def cast(tree):
        return type(tree)(*(np.asarray(a).astype(np.float32)
                            if np.issubdtype(np.asarray(a).dtype,
                                             np.floating)
                            else np.asarray(a) for a in tree))

    for lane, wave in ((lanes[0], True), (dense[0], False)):
        rtrees = [cast(t) for t in (lane.const, lane.init, lane.batch,
                                    lane.ptab, lane.pinit)]
        port = _carry(lane, "float32")
        ptrees = [type(t)(*(np.asarray(a)[None] for a in t))
                  for t in (port.const, port.init, port.batch, port.ptab,
                            port.pinit)]
        if wave:
            want = ref.solve_lane_wave_preempt(*rtrees, spread_alg=False,
                                               dtype_name="float32")
            got = [g[0] for g in preempt.solve_lane_wave_preempt(
                *ptrees, spread_alg=False, dtype_name="float32",
                device="cpu")]
        else:
            want = ref.solve_placements_preempt(*rtrees, spread_alg=False,
                                                dtype_name="float32")
            out = preempt.solve_placements_preempt(
                *ptrees, spread_alg=False, dtype_name="float32",
                device="cpu")
            got = [t[0].numpy() for t in out[:4]]
        for i in (0, 2, 3):
            np.testing.assert_array_equal(np.asarray(got[i]),
                                          np.asarray(want[i]))
        np.testing.assert_array_equal(np.asarray(got[1]),
                                      np.asarray(want[1]))


def test_gpu_tier5_lane_rides_the_windowed_kernel_in_both():
    """test_tier5_devices' shape: GPU nodes, fillers holding no GPU, a
    priority-70 one-GPU ask. The uniform device lane passes the wave gate
    in both packages (device capacity as a countdown column) and the
    results agree; every placement lands on a GPU node."""
    h, nodes = _world(11, 96, gpus=True, cpu=500)
    lane = _pack(h, nodes, 30, gpu=True, job_id="gpu-preempt-job")
    assert lane.wavefront_ok()
    port = _carry(lane)
    assert port.wavefront_ok()
    groups = fuse_lanes([port])
    assert [g.wave for g in groups] == [True]
    want = ref_fuse_and_solve([lane])
    got = fuse_and_solve([port], device="cpu")
    _assert_same(want, got)
    chosen, _, _, rows = got[0]
    idx, _ = placements(port, chosen)
    assert (idx >= 0).all() and (idx % 2 == 0).all()
    assert rows.any()


def _unpermute(a, perm):
    a = np.asarray(a)
    out = np.empty_like(a)
    out[perm] = a
    return out


def test_pack_lane_arrays_rebuilds_preemption_tables(tier5):
    """From the reference lane's tables in original node order,
    pack_lane_arrays(preemption=PreemptInfo) shuffles them into the
    reference's PreemptTables / PreemptState, field by field."""
    h, nodes = _world(11, 64, gpus=True, cpu=500)
    for lane in (tier5[0][1], _pack(h, nodes, 12, gpu=True,
                                    job_id="gpu-rebuild")):
        m = lane.matrix
        perm = np.concatenate([np.asarray(lane.order, dtype=np.int64),
                               np.arange(m.n_real, m.n_pad)])
        c, s, b, pt, ps = (lane.const, lane.init, lane.batch, lane.ptab,
                           lane.pinit)

        def orig(a):
            out = np.empty_like(np.asarray(a))
            out[..., perm] = np.asarray(a)
            return out

        matrix = NodeMatrix(n_real=m.n_real, n_pad=m.n_pad,
                            node_ids=list(m.node_ids), cpu_cap=m.cpu_cap,
                            mem_cap=m.mem_cap, disk_cap=m.disk_cap,
                            dyn_free=m.dyn_free, valid=m.valid)
        usage = UsageState(
            used_cpu=orig(s.used_cpu), used_mem=orig(s.used_mem),
            used_disk=orig(s.used_disk), placed_jobtg=orig(s.placed),
            placed_job=orig(s.placed_job),
            dyn_used=m.dyn_free - orig(s.dyn_avail))
        info = PreemptInfo(
            cpu=_unpermute(pt.cpu, perm), mem=_unpermute(pt.mem, perm),
            disk=_unpermute(pt.disk, perm), prio=_unpermute(pt.prio, perm),
            maxp=_unpermute(pt.maxp, perm), grp=_unpermute(pt.grp, perm),
            valid=_unpermute(pt.valid, perm), job_prio=int(pt.job_prio),
            counts=np.asarray(ps.counts))
        kw = {}
        if c.dev_aff.shape[0]:
            kw["devices"] = DeviceInfo(
                affinity=orig(c.dev_aff), count=c.dev_count,
                sum_weight=float(c.dev_sum_weight), free=orig(s.dev_free))
        rebuilt = pack_lane_arrays(
            matrix, usage, orig(c.feasible),
            ask=(float(b.ask_cpu[0]), float(b.ask_mem[0]),
                 float(b.ask_disk[0])),
            count=int(b.count[0]), n_places=b.ask_cpu.shape[0],
            eval_id=lane.service.ctx.plan.eval_id,
            state_index=lane.service.ctx.state.latest_index(), preemption=info, device="cpu",
            **kw)
        np.testing.assert_array_equal(np.asarray(rebuilt.order),
                                      np.asarray(lane.order))
        for port_tree, ref_tree in ((rebuilt.ptab, pt), (rebuilt.pinit, ps),
                                    (rebuilt.const, c), (rebuilt.init, s)):
            for name in type(port_tree)._fields:
                want = np.asarray(getattr(ref_tree, name))
                got = np.asarray(getattr(port_tree, name))
                assert got.dtype == want.dtype, name
                np.testing.assert_array_equal(got, want, err_msg=name)
        assert rebuilt.wavefront_ok() == lane.wavefront_ok()
