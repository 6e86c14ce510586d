"""Slices 1 and 2 end to end on the CPU: lanes the reference packs from a real
scheduler world (nomad_tpu.mock nodes and jobs, a Harness state store,
TpuPlacementService.pack) solve identically through
nomad_tpu.solver.batch.fuse_and_solve and through the port's
fuse_and_solve after lane_from_reference carries them over: chosen and
n_yielded exactly, float64 scores within rtol=1e-12 (the reference's own
gate). The port's pack_lane_arrays rebuilds the reference's order, const,
init and batch from the same world's node-axis arrays."""
import random

import numpy as np
import pytest
import torch

from nomad_tpu import mock
from nomad_tpu.scheduler import Harness
from nomad_tpu.scheduler.context import EvalContext
from nomad_tpu.scheduler.reconcile import AllocPlaceResult
from nomad_tpu.solver import guard
from nomad_tpu.solver.batch import fuse_and_solve as ref_fuse_and_solve
from nomad_tpu.solver.service import TpuPlacementService
from nomad_tpu.structs import (
    Affinity, Constraint, DeviceRequest, NetworkResource, Plan, Port, Spread,
    SpreadTarget)

from nomad_tpu_torch.carry import lane_from_reference
from nomad_tpu_torch.solver.batch import fuse_and_solve, fuse_lanes
from nomad_tpu_torch.solver.service import pack_lane_arrays, placements
from nomad_tpu_torch.tensor.pack import (
    DeviceInfo, DistinctPropertyInfo, NodeMatrix, SpreadInfo, UsageState)

# One intra-op thread: the port's CPU tensors are small, and the test
# run already keeps one xdist worker busy per core.
torch.set_num_threads(1)

N_NODES = 300


@pytest.fixture(autouse=True)
def clean_guard():
    guard._reset_for_tests()
    yield
    guard._reset_for_tests()


@pytest.fixture(scope="module")
def world():
    h = Harness()
    nodes = []
    for i in range(N_NODES):
        n = mock.node()
        n.id = f"slice-node-{i:04d}"
        n.node_resources.cpu.cpu_shares = (2000, 4000, 8000)[i % 3]
        n.node_resources.memory.memory_mb = (4096, 8192, 16384)[i % 3]
        n.meta["rack"] = f"r{i % 7}"
        n.compute_class()
        nodes.append(n)
        h.state.upsert_node(n)
    snap = h.state.snapshot()
    specs = [
        # (kind, count)
        ("plain", 60), ("plain", 45), ("spread", 40), ("penalty", 30)]
    lanes, inputs = [], []
    for i, (kind, count) in enumerate(specs):
        job = mock.job(id=f"slice-job-{i}")
        tg = job.task_groups[0]
        tg.count = count
        if kind == "spread":
            tg.spreads = [Spread(attribute="${meta.rack}", weight=50),
                          Spread(attribute="${node.datacenter}", weight=25,
                                 spread_target=[SpreadTarget("dc1", 100)])]
        h.state.upsert_job(job)
        plan = Plan(eval_id=f"slice-eval-{i:027d}", priority=50, job=job)
        ctx = EvalContext(snap, plan)
        places = [AllocPlaceResult(name=f"{job.id}.{tg.name}[{k}]",
                                   task_group=tg) for k in range(count)]
        pen = None
        if kind == "penalty":
            pen = [({nodes[(7 * k) % N_NODES].id} if k % 3 == 0 else None)
                   for k in range(count)]
        svc = TpuPlacementService(ctx, job, batch_mode=False,
                                  spread_alg=False)
        lane = svc.pack(tg, places, nodes, pen)
        assert lane is not None and lane.wavefront_ok()
        lanes.append(lane)
        inputs.append(dict(eval_id=plan.eval_id,
                           state_index=snap.latest_index(), count=count,
                           ask=(500.0, 256.0, 150.0),
                           penalty=[next(iter(p)) if p else None
                                    for p in pen] if pen else None))
    return lanes, inputs


def _carry(lanes):
    return [lane_from_reference(l.const, l.init, l.batch, l.order,
                                dtype_name=l.dtype_name,
                                spread_alg=l.spread_alg,
                                node_ids=l.matrix.node_ids, device="cpu")
            for l in lanes]


def _assert_results_equal(want, got):
    assert len(want) == len(got)
    for (cw, sw, yw), (cg, sg, yg) in zip(want, got):
        np.testing.assert_array_equal(cg, cw)
        np.testing.assert_array_equal(yg, yw)
        np.testing.assert_allclose(sg, sw, rtol=1e-12)


def test_fused_slice_matches_reference(world):
    """All four lanes in one call: the two plain lanes and the penalty
    lane share a fuse key (the penalty routes that group to the compact
    kernel, as in the reference); the spread lane is its own B=128
    group."""
    lanes, _ = world
    ports = _carry(lanes)
    groups = fuse_lanes(ports)
    assert sorted(len(g.idxs) for g in groups) == [1, 3]
    want = ref_fuse_and_solve(lanes)
    got = fuse_and_solve(ports, device="cpu")
    _assert_results_equal(want, got)
    for lane, (chosen, _, _) in zip(ports, got):
        assert (chosen >= 0).all()


def test_block_group_matches_reference(world):
    """The plain lanes alone (one of them twice) take the run-block
    kernel, padded from E=3 to E=4."""
    lanes, _ = world
    picked = [lanes[0], lanes[1], lanes[0]]
    ports = _carry(picked)
    assert [g.e_pad for g in fuse_lanes(ports)] == [4]
    want = ref_fuse_and_solve(picked)
    got = fuse_and_solve(ports, device="cpu")
    _assert_results_equal(want, got)


def _unpermute(a, perm):
    a = np.asarray(a)
    out = np.empty_like(a)
    out[..., perm] = a
    return out


def test_pack_lane_arrays_rebuilds_reference_tables(world):
    """From each reference lane's node-axis arrays in original node order,
    pack_lane_arrays rebuilds the same shuffle and tables."""
    lanes, inputs = world
    for lane, inp in zip(lanes, inputs):
        m = lane.matrix
        perm = np.concatenate([np.asarray(lane.order, dtype=np.int64),
                               np.arange(m.n_real, m.n_pad)])
        c, s = lane.const, lane.init
        matrix = NodeMatrix(n_real=m.n_real, n_pad=m.n_pad,
                            node_ids=list(m.node_ids), cpu_cap=m.cpu_cap,
                            mem_cap=m.mem_cap, disk_cap=m.disk_cap,
                            dyn_free=m.dyn_free, valid=m.valid)
        usage = UsageState(
            used_cpu=_unpermute(s.used_cpu, perm),
            used_mem=_unpermute(s.used_mem, perm),
            used_disk=_unpermute(s.used_disk, perm),
            placed_jobtg=_unpermute(s.placed, perm),
            placed_job=_unpermute(s.placed_job, perm),
            dyn_used=m.dyn_free - _unpermute(s.dyn_avail, perm))
        spread = None
        if c.spread_vidx.shape[0]:
            spread = SpreadInfo(
                n_spreads=int(c.n_spreads),
                value_index=_unpermute(c.spread_vidx, perm),
                n_values=c.spread_desired.shape[1],
                desired=np.asarray(c.spread_desired),
                has_targets=np.asarray(c.spread_has_targets),
                weights=np.asarray(c.spread_weights),
                sum_weights=float(c.spread_sum_weights),
                initial_counts=np.asarray(s.spread_counts))
        rebuilt = pack_lane_arrays(
            matrix, usage, _unpermute(c.feasible, perm), ask=inp["ask"],
            count=inp["count"], n_places=inp["count"],
            eval_id=inp["eval_id"], state_index=inp["state_index"],
            affinity=(_unpermute(c.affinity, perm)
                      if bool(c.has_affinity) else None),
            spread_info=spread, penalty_node_ids=inp["penalty"],
            distinct_hosts=bool(c.distinct_hosts),
            distinct_job_level=bool(c.distinct_job_level),
            device="cpu")
        assert rebuilt.dtype_name == lane.dtype_name == "float64"
        np.testing.assert_array_equal(np.asarray(rebuilt.order),
                                      np.asarray(lane.order))
        for port_tree, ref_tree in ((rebuilt.const, lane.const),
                                    (rebuilt.init, lane.init),
                                    (rebuilt.batch, lane.batch)):
            for name in type(port_tree)._fields:
                want = np.asarray(getattr(ref_tree, name))
                got = np.asarray(getattr(port_tree, name))
                assert got.dtype == want.dtype, name
                np.testing.assert_array_equal(got, want, err_msg=name)


def test_placements_map_back_to_nodes(world):
    lanes, _ = world
    port = _carry(lanes[:1])[0]
    chosen = fuse_and_solve([port], device="cpu")[0][0]
    idx, ids = placements(port, chosen)
    order = np.asarray(lanes[0].order)
    np.testing.assert_array_equal(idx, order[chosen])
    assert ids == [f"slice-node-{i:04d}" for i in idx]
    idx, ids = placements(port, np.array([-1, chosen[0]]))
    assert idx[0] == -1 and ids[0] is None and ids[1] is not None


# --------------------------------------------------------------------------
# slice 2: lanes the wave gate refuses take the dense scan

@pytest.fixture(scope="module")
def dense_world():
    """One fleet, one eval per lane kind: a plain lane (wave), a spread
    lane at count 140 (window 140 > 128 slots: dense), a
    distinct_property lane (job scope on ${meta.rack}), a task-group
    distinct_property lane, a reserved-core lane with a static and a
    dynamic port, and a device lane with an affinity (all four dense)."""
    rng = random.Random(5)
    h = Harness()
    nodes = []
    for i in range(N_NODES):
        n = (mock.gpu_node(count=rng.choice([1, 2, 4])) if i % 3 == 0
             else mock.node())
        n.id = f"dense-slice-node-{i:04d}"
        k = (4, 8, 16)[i % 3]
        n.node_resources.cpu.cpu_shares = (2000, 4000, 8000)[i % 3]
        n.node_resources.cpu.total_core_count = k
        n.node_resources.cpu.reservable_cores = list(range(k))
        n.node_resources.memory.memory_mb = (4096, 8192, 16384)[i % 3]
        n.attributes["cpu.numcores"] = str(k)
        n.meta["rack"] = f"r{i % 7}"
        n.compute_class()
        nodes.append(n)
        h.state.upsert_node(n)
    snap = h.state.snapshot()
    specs = ["plain", "spread", "dp_job", "dp_tg", "cores", "devices"]
    lanes = []
    for i, kind in enumerate(specs):
        job = mock.job(id=f"dense-slice-job-{kind}")
        tg = job.task_groups[0]
        task = tg.tasks[0]
        tg.count = 30
        if kind == "spread":
            tg.count = 140
            task.resources.cpu = 100
            task.resources.memory_mb = 64
            tg.spreads = [Spread(attribute="${meta.rack}", weight=50),
                          Spread(attribute="${node.datacenter}", weight=25,
                                 spread_target=[SpreadTarget("dc1", 100)])]
        elif kind == "dp_job":
            job.constraints = list(job.constraints) + [Constraint(
                l_target="${meta.rack}", r_target="3",
                operand="distinct_property")]
        elif kind == "dp_tg":
            tg.constraints = [Constraint(l_target="${attr.cpu.numcores}",
                                         r_target="4",
                                         operand="distinct_property")]
        elif kind == "cores":
            task.resources.cores = 2
            tg.networks = [NetworkResource(
                reserved_ports=[Port(label="admin", value=8080)],
                dynamic_ports=[Port(label="http")])]
        elif kind == "devices":
            task.resources.devices = [DeviceRequest(
                name="gpu", count=1, affinities=[
                    Affinity(l_target="${device.attr.cuda_cores}",
                             r_target="3584", operand=">=", weight=50)])]
        h.state.upsert_job(job)
        plan = Plan(eval_id=f"dense-slice-eval-{i:020d}", priority=50,
                    job=job)
        ctx = EvalContext(snap, plan)
        places = [AllocPlaceResult(name=f"{job.id}.{tg.name}[{k}]",
                                   task_group=tg) for k in range(tg.count)]
        svc = TpuPlacementService(ctx, job, batch_mode=False,
                                  spread_alg=False)
        lane = svc.pack(tg, places, nodes)
        assert lane is not None
        assert lane.wavefront_ok() == (kind == "plain"), kind
        lanes.append(lane)
    return dict(zip(specs, lanes)), h, snap, nodes


def test_mixed_wave_and_dense_dispatch_matches_reference(dense_world,
                                                         world):
    """Wave, dense spread, distinct_property, cores and device lanes in
    one fuse_and_solve call equal the reference's fuse_and_solve on the
    same lanes; each dense kind forms its own fused group."""
    by_kind, _, _, _ = dense_world
    lanes = list(by_kind.values()) + list(world[0][:2])
    ports = _carry(lanes)
    groups = fuse_lanes(ports)
    assert sorted((g.wave, len(g.idxs)) for g in groups) == [
        (False, 1)] * 5 + [(True, 3)]
    want = ref_fuse_and_solve(lanes)
    got = fuse_and_solve(ports, device="cpu")
    _assert_results_equal(want, got)
    for kind, (chosen, _, _) in zip(by_kind, got):
        assert (chosen >= 0).sum() >= 10, kind


def test_preemption_lane_matches_reference(dense_world):
    """A lane the reference packs with preemption tables carries across
    with them and solves as the reference's does: the same chosen,
    n_yielded and eviction rows, on the same kernel."""
    by_kind, h, snap, nodes = dense_world
    job = mock.job(id="dense-slice-preempt")
    job.priority = 90
    tg = job.task_groups[0]
    tg.count = 4
    h.state.upsert_job(job)
    plan = Plan(eval_id="dense-slice-preempt-eval-0000", priority=90,
                job=job)
    ctx = EvalContext(snap, plan)
    places = [AllocPlaceResult(name=f"{job.id}.{tg.name}[{k}]",
                               task_group=tg) for k in range(tg.count)]
    svc = TpuPlacementService(ctx, job, batch_mode=False, spread_alg=False,
                              preempt=True)
    lane = svc.pack(tg, places, nodes)
    assert lane is not None and lane.ptab is not None
    port = lane_from_reference(lane.const, lane.init, lane.batch,
                               lane.order, ptab=lane.ptab, pinit=lane.pinit,
                               node_ids=lane.matrix.node_ids, device="cpu")
    assert port.wavefront_ok() == lane.wavefront_ok()
    (cw, sw, yw, ew), = ref_fuse_and_solve([lane])
    (cg, sg, yg, eg), = fuse_and_solve([port], device="cpu")
    np.testing.assert_array_equal(cg, cw)
    np.testing.assert_array_equal(yg, yw)
    np.testing.assert_array_equal(eg, ew)
    np.testing.assert_allclose(sg, sw, rtol=1e-12)
    assert (cg >= 0).all()


def test_carry_keeps_dense_tables(dense_world):
    """lane_from_reference carries the distinct_property, device and
    reserved-core tables field by field, floating ones in the lane
    dtype, except a lane with no device asks: its dev_sum_weight stays at
    the packer's float32 default, as both packages' packers leave it."""
    by_kind, _, _, _ = dense_world
    for kind in ("dp_job", "dp_tg", "cores", "devices"):
        lane = by_kind[kind]
        for dtype_name in ("float64", "float32"):
            port = lane_from_reference(lane.const, lane.init, lane.batch,
                                       lane.order, dtype_name=dtype_name,
                                       device="cpu")
            for port_tree, ref_tree in ((port.const, lane.const),
                                        (port.init, lane.init),
                                        (port.batch, lane.batch)):
                for name in ("dp_vidx", "dp_limit", "dp_tg_scope",
                             "dp_counts", "dev_aff", "dev_count",
                             "dev_sum_weight", "dev_free", "mhz_per_core",
                             "cores_free", "ask_cores"):
                    if name not in type(port_tree)._fields:
                        continue
                    want = np.asarray(getattr(ref_tree, name))
                    got = np.asarray(getattr(port_tree, name))
                    np.testing.assert_array_equal(got, want, err_msg=name)
                    if (name == "dev_sum_weight"
                            and np.asarray(lane.const.dev_aff).size == 0):
                        assert got.dtype == np.float32, name
                    elif np.issubdtype(want.dtype, np.floating):
                        assert got.dtype == np.dtype(dtype_name), name
                    else:
                        assert got.dtype == want.dtype, name
    assert by_kind["dp_job"].const.dp_vidx.shape[0] == 1
    assert by_kind["devices"].const.dev_aff.shape[0] == 1
    assert by_kind["cores"].const.mhz_per_core.shape[0] > 0


def test_pack_lane_arrays_rebuilds_dense_tables(dense_world):
    """From the dense lanes' node-axis arrays in original node order,
    pack_lane_arrays rebuilds every table: distinct_property, devices,
    reserved cores, the static-port mask and the dynamic-port count."""
    by_kind, h, snap, _ = dense_world
    for kind in ("dp_job", "dp_tg", "cores", "devices"):
        lane = by_kind[kind]
        m = lane.matrix
        perm = np.concatenate([np.asarray(lane.order, dtype=np.int64),
                               np.arange(m.n_real, m.n_pad)])
        c, s, b = lane.const, lane.init, lane.batch
        matrix = NodeMatrix(n_real=m.n_real, n_pad=m.n_pad,
                            node_ids=list(m.node_ids), cpu_cap=m.cpu_cap,
                            mem_cap=m.mem_cap, disk_cap=m.disk_cap,
                            dyn_free=m.dyn_free, valid=m.valid)
        usage = UsageState(
            used_cpu=_unpermute(s.used_cpu, perm),
            used_mem=_unpermute(s.used_mem, perm),
            used_disk=_unpermute(s.used_disk, perm),
            placed_jobtg=_unpermute(s.placed, perm),
            placed_job=_unpermute(s.placed_job, perm),
            dyn_used=m.dyn_free - _unpermute(s.dyn_avail, perm))
        kw = {}
        if c.dp_vidx.shape[0]:
            kw["distinct_property"] = DistinctPropertyInfo(
                value_index=_unpermute(c.dp_vidx, perm), limit=c.dp_limit,
                tg_scope=c.dp_tg_scope, counts=s.dp_counts)
        if c.dev_aff.shape[0]:
            kw["devices"] = DeviceInfo(
                affinity=_unpermute(c.dev_aff, perm), count=c.dev_count,
                sum_weight=float(c.dev_sum_weight),
                free=_unpermute(s.dev_free, perm))
        if c.mhz_per_core.shape[0]:
            kw.update(ask_cores=int(b.ask_cores[0]),
                      mhz_per_core=_unpermute(c.mhz_per_core, perm),
                      cores_free=_unpermute(s.cores_free, perm))
        if bool(b.has_static[0]):
            kw["static_ports_free"] = _unpermute(s.static_free, perm)
        count = int(b.count[0])
        rebuilt = pack_lane_arrays(
            matrix, usage, _unpermute(c.feasible, perm),
            ask=(float(b.ask_cpu[0]), float(b.ask_mem[0]),
                 float(b.ask_disk[0])),
            count=count, n_places=b.ask_cpu.shape[0],
            eval_id=lane.service.ctx.plan.eval_id,
            state_index=snap.latest_index(),
            n_dyn_ports=int(b.n_dyn_ports[0]), device="cpu", **kw)
        for port_tree, ref_tree in ((rebuilt.const, lane.const),
                                    (rebuilt.init, lane.init),
                                    (rebuilt.batch, lane.batch)):
            for name in type(port_tree)._fields:
                want = np.asarray(getattr(ref_tree, name))
                got = np.asarray(getattr(port_tree, name))
                assert got.dtype == want.dtype, (kind, name)
                np.testing.assert_array_equal(got, want,
                                              err_msg=f"{kind} {name}")
