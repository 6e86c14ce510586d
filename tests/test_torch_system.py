"""The port's system-job fit against the JAX program it replaces.

nomad_tpu_torch.solver.system (the plain PyTorch version, which the CPU
wrapper runs) must reproduce nomad_tpu/solver/binpack.py's
_solve_system_impl on the same inputs: fit exactly, scores within
rtol=1e-12 in float64 and 1e-6 in float32 (the gates of
tests/test_torch_dense.py) and in fact to the bit -- XLA lowers the
score's division by 18 to a multiply by the rounded reciprocal, and the
port does the same. solve_system_arrays must map fit and score back to
node order as TpuPlacementService.solve_system does.
"""
import functools
import random

import numpy as np
import pytest
import torch

import chip_smoke
from nomad_tpu import mock
from nomad_tpu.scheduler import Harness
from nomad_tpu.scheduler.context import EvalContext
from nomad_tpu.scheduler.reconcile import AllocPlaceResult
from nomad_tpu.solver import binpack as ref
from nomad_tpu.solver.service import TpuPlacementService
from nomad_tpu.structs import NetworkResource, Plan, Port
from test_torch_dense import RTOL, _cast
from test_torch_slice import _unpermute

from nomad_tpu_torch import kernels
from nomad_tpu_torch.carry import lane_from_reference
from nomad_tpu_torch.solver import binpack as port_bp
from nomad_tpu_torch.solver import dense, system
from nomad_tpu_torch.solver.service import placements, solve_system_arrays
from nomad_tpu_torch.tensor.pack import NodeMatrix, UsageState

torch.set_num_threads(1)


def _assert_same(want, got, dtype_name):
    fit_w, sc_w = (np.asarray(x) for x in want)
    fit, sc = (x.numpy() for x in got)
    np.testing.assert_array_equal(fit, fit_w)
    np.testing.assert_allclose(sc, sc_w, rtol=RTOL[dtype_name])
    np.testing.assert_array_equal(sc, sc_w)


SYSTEM_FUZZ = {"plain": (), "cores": ("cores",), "ports": ("ports",),
               "scarce": ("scarce", "ports", "cores")}


@pytest.mark.parametrize("spread_alg", [False, True])
@pytest.mark.parametrize("dtype_name", ["float32", "float64"])
@pytest.mark.parametrize("world", sorted(SYSTEM_FUZZ))
def test_fuzz_matches_jax(world, dtype_name, spread_alg):
    """Each fuzz lane through the reference's solve_system and the
    port's; the port also takes them stacked (E = 3) in one call."""
    rng = np.random.default_rng(sorted(SYSTEM_FUZZ).index(world))
    lanes = [chip_smoke.dense_fuzz_tables(
        np, rng, n=200, n_pad=256, p=4, dtype=dtype_name, limit=2,
        features=SYSTEM_FUZZ[world]) for _ in range(3)]
    wants = [ref.solve_system(ref.NodeConst(**c), ref.NodeState(**s),
                              ref.PlacementBatch(**b), spread_alg=spread_alg,
                              dtype_name=dtype_name) for c, s, b in lanes]
    stacked = [
        cls(**{f: np.stack([np.asarray(ln[k][f]) for ln in lanes])
               for f in lanes[0][k]})
        for k, cls in enumerate((port_bp.NodeConst, port_bp.NodeState,
                                 port_bp.PlacementBatch))]
    c, s, b = dense.lane_tensors(*stacked, dtype_name=dtype_name,
                                 device=torch.device("cpu"))
    fit, score = system.system_fit(c, s, b, spread_alg=spread_alg)
    for e, want in enumerate(wants):
        _assert_same(want, (fit[e], score[e]), dtype_name)
    assert fit.any() and not fit.all()


def _fleet(rng, n):
    nodes = []
    for i in range(n):
        node = mock.node()
        k = rng.choice([2, 4, 8])
        node.node_resources.cpu.cpu_shares = k * 1000
        node.node_resources.cpu.total_core_count = k
        node.node_resources.cpu.reservable_cores = list(range(k))
        node.node_resources.memory.memory_mb = rng.choice([4096, 8192])
        node.id = f"system-node-{i:04d}"
        node.compute_class()
        nodes.append(node)
    return nodes


@functools.lru_cache(maxsize=None)
def _system_lane(kind):
    """A system job packed by TpuPlacementService.pack as solve_system
    packs it: one place per node, over every node."""
    rng = random.Random(len(kind))
    h = Harness()
    nodes = _fleet(rng, 40)
    for node in nodes:
        h.state.upsert_node(node)
    job = mock.system_job(id=f"system-{kind}")
    tg = job.task_groups[0]
    task = tg.tasks[0]
    task.resources.cpu = 1500
    task.resources.memory_mb = 3000
    if kind == "cores":
        task.resources.cores = 3
    elif kind == "ports":
        tg.networks = [NetworkResource(
            reserved_ports=[Port(label="admin", value=8080)],
            dynamic_ports=[Port(label="http")])]
    h.state.upsert_job(job)
    plan = Plan(eval_id=f"system-eval-{kind:>24}", priority=100, job=job)
    ctx = EvalContext(h.state.snapshot(), plan)
    places = [AllocPlaceResult(name=f"{job.id}.{tg.name}[0]", task_group=tg)
              for _ in nodes]
    svc = TpuPlacementService(ctx, job, batch_mode=False, spread_alg=False)
    lane = svc.pack(tg, places, nodes)
    assert lane is not None
    return lane


@pytest.mark.parametrize("dtype_name", ["float32", "float64"])
@pytest.mark.parametrize("kind", ["plain", "cores", "ports"])
def test_reference_packed_system_lane_matches(kind, dtype_name):
    lane = _system_lane(kind)
    const, init, batch = (_cast(t, dtype_name)
                          for t in (lane.const, lane.init, lane.batch))
    batch1 = type(batch)(*(np.asarray(a)[:1] for a in batch))
    want = ref.solve_system(const, init, batch1, spread_alg=False,
                            dtype_name=dtype_name)
    port = lane_from_reference(const, init, batch, lane.order,
                               dtype_name=dtype_name, device="cpu")
    got = system.solve_system(port.const, port.init, port.batch,
                              spread_alg=False, dtype_name=dtype_name,
                              device="cpu")
    assert got[1].dtype == getattr(torch, dtype_name)
    _assert_same(want, got, dtype_name)
    fit = got[0].numpy()
    assert fit.any() and not fit.all()


@pytest.mark.parametrize("kind,spread_alg", [
    ("plain", False), ("plain", True), ("cores", False), ("ports", False)])
def test_solve_system_arrays_maps_back_like_the_service(kind, spread_alg):
    """From the lane's node-axis arrays in original order,
    solve_system_arrays rebuilds the lane and returns what
    TpuPlacementService.solve_system hands to materialize: per node its
    shuffled position where it fits (else -1) and its score."""
    lane = _system_lane(kind)
    m = lane.matrix
    n, n_pad = m.n_real, m.n_pad
    perm = np.concatenate([np.asarray(lane.order, dtype=np.int64),
                           np.arange(n, n_pad)])
    c, s, b = lane.const, lane.init, lane.batch
    matrix = NodeMatrix(n_real=n, n_pad=n_pad, node_ids=list(m.node_ids),
                        cpu_cap=m.cpu_cap, mem_cap=m.mem_cap,
                        disk_cap=m.disk_cap, dyn_free=m.dyn_free,
                        valid=m.valid)
    usage = UsageState(
        used_cpu=_unpermute(s.used_cpu, perm),
        used_mem=_unpermute(s.used_mem, perm),
        used_disk=_unpermute(s.used_disk, perm),
        placed_jobtg=_unpermute(s.placed, perm),
        placed_job=_unpermute(s.placed_job, perm),
        dyn_used=m.dyn_free - _unpermute(s.dyn_avail, perm))
    kw = {}
    if c.mhz_per_core.shape[0]:
        kw.update(ask_cores=int(b.ask_cores[0]),
                  mhz_per_core=_unpermute(c.mhz_per_core, perm),
                  cores_free=_unpermute(s.cores_free, perm))
    if bool(b.has_static[0]):
        kw["static_ports_free"] = _unpermute(s.static_free, perm)
    port_lane, chosen, scores = solve_system_arrays(
        matrix, usage, _unpermute(c.feasible, perm),
        ask=(float(b.ask_cpu[0]), float(b.ask_mem[0]),
             float(b.ask_disk[0])),
        eval_id=lane.service.ctx.plan.eval_id,
        state_index=lane.service.ctx.state.latest_index(),
        n_dyn_ports=int(b.n_dyn_ports[0]), spread_alg=spread_alg,
        device="cpu", **kw)
    batch1 = type(b)(*(np.asarray(a)[:1] for a in b))
    fit, score = (np.asarray(x) for x in ref.solve_system(
        c, s, batch1, spread_alg=spread_alg, dtype_name=lane.dtype_name))
    inv = np.empty(n, dtype=np.int64)
    inv[np.asarray(lane.order)] = np.arange(n)
    np.testing.assert_array_equal(chosen, np.where(fit[inv], inv, -1))
    np.testing.assert_array_equal(scores, score[inv])
    idx, ids = placements(port_lane, chosen)
    fits = chosen >= 0
    np.testing.assert_array_equal(idx[fits], np.arange(n)[fits])
    assert ids[int(np.argmax(fits))] == m.node_ids[int(np.argmax(fits))]


def test_wrapper_takes_plain_version_on_cpu_and_needs_a_card_by_default():
    lane = _system_lane("cores")
    port = lane_from_reference(lane.const, lane.init, lane.batch,
                               lane.order, device="cpu")
    before = kernels.SYSTEM_FIT.launches
    got = system.solve_system(port.const, port.init, port.batch,
                              spread_alg=False, device="cpu")
    assert kernels.SYSTEM_FIT.launches == before
    row = [type(t)(*(np.asarray(a)[None] for a in t))
           for t in (port.const, port.init, port.batch)]
    c, s, b = dense.lane_tensors(*row, dtype_name="float64",
                                 device=torch.device("cpu"))
    want = system.system_fit_plain(c, s, b, spread_alg=False)
    assert torch.equal(got[0], want[0][0]) and torch.equal(got[1],
                                                           want[1][0])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            system.solve_system(port.const, port.init, port.batch,
                                spread_alg=False)
    with pytest.raises(TypeError):
        system.system_fit(c._replace(cpu_cap=c.cpu_cap.float()), s, b,
                          spread_alg=False)
