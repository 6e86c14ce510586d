"""The port's dense greedy scan against the JAX program it replaces.

nomad_tpu_torch.solver.dense (the plain PyTorch version, which the CPU
wrapper runs) must reproduce nomad_tpu/solver/binpack.py's
_solve_placements_impl, vmapped over lanes and run on the CPU as the
reference's own tests run it, on the same inputs:

  * chosen and n_yielded exactly, and every field of the final NodeState;
  * scores within rtol=1e-12 in float64 (the reference's own gate,
    tests/test_wavefront.py) and rtol=1e-6 in float32 -- about eight
    float32 ulps. The port evaluates the same IEEE operations in the same
    order as XLA's lowering (the score's reciprocal multiply-add, the
    reserved-core cpu ask as a fused multiply-add, libm pow), so scores
    are expected to agree to the bit, and the tests assert that too.

Worlds: a numpy-seeded fuzz over every feature the dense path models
(chip_smoke.dense_fuzz_tables, the same generator chip_smoke.py feeds the
kernel on the card), several lanes per dispatch; lanes packed by
TpuPlacementService.pack from the tests/test_solver_parity.py and
tests/test_tier5_devices.py worlds; a world wide enough for the
reference's FAST_T shortcut to take each of its branches; lanes that run
out of capacity mid-scan.
"""
import functools
import random
from functools import partial

import jax
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
from nomad_tpu.structs import (
    Affinity, Constraint, DeviceRequest, NetworkResource, Plan, Port,
    Spread, SpreadTarget)

from nomad_tpu_torch import kernels
from nomad_tpu_torch.carry import lane_from_reference
from nomad_tpu_torch.solver import binpack as port_bp
from nomad_tpu_torch.solver import dense

# One intra-op thread: the port's CPU tensors are small, and the test
# run already keeps one xdist worker busy per core.
torch.set_num_threads(1)

RTOL = {"float64": 1e-12, "float32": 1e-6}


@functools.lru_cache(maxsize=None)
def _ref_program(spread_alg, dtype_name):
    return jax.jit(jax.vmap(partial(
        ref._solve_placements_impl, spread_alg=spread_alg,
        dtype_name=dtype_name)))


def _stack(trees):
    return type(trees[0])(*(np.stack([np.asarray(f) for f in fields])
                            for fields in zip(*trees)))


def _cast(tree, dtype_name):
    """The lane tables in ``dtype_name`` (floating fields only), as the
    reference service packs them for that dtype."""
    return type(tree)(*(np.asarray(a).astype(dtype_name)
                        if np.issubdtype(np.asarray(a).dtype, np.floating)
                        else np.asarray(a) for a in tree))


def assert_dense_equal(want, got, dtype_name):
    """Reference (chosen, scores, n_yielded, final NodeState) vs the
    port's DenseOut: decisions and state exactly, scores to the bit
    (and within the stated rtol)."""
    ch_w, sc_w, ny_w, st_w = want
    np.testing.assert_array_equal(got.chosen.numpy(), np.asarray(ch_w))
    np.testing.assert_array_equal(got.n_yielded.numpy(), np.asarray(ny_w))
    sc = got.scores.numpy()
    np.testing.assert_allclose(sc, np.asarray(sc_w), rtol=RTOL[dtype_name])
    np.testing.assert_array_equal(sc, np.asarray(sc_w))
    for name in port_bp.NodeState._fields:
        np.testing.assert_array_equal(
            getattr(got.state, name).numpy(), np.asarray(getattr(st_w, name)),
            err_msg=name)


def _solve_both(const, init, batch, *, spread_alg, dtype_name):
    """Stacked reference tables through the JAX program and, carried
    field by field, through the port's CPU wrapper."""
    want = _ref_program(spread_alg, dtype_name)(const, init, batch)
    got = dense.solve_placements(
        *(port_bp_tree(t) for t in (const, init, batch)),
        spread_alg=spread_alg, dtype_name=dtype_name, device="cpu")
    return want, got


def port_bp_tree(tree):
    cls = {"NodeConst": port_bp.NodeConst, "NodeState": port_bp.NodeState,
           "PlacementBatch": port_bp.PlacementBatch}[type(tree).__name__]
    return cls(*(np.asarray(getattr(tree, f)) for f in cls._fields))


def _fuzz_lanes(seed, features, dtype_name, *, E=3, n=48, n_pad=64, p=40,
                limit=None, n_active=None):
    rng = np.random.default_rng(seed)
    if limit is None:
        limit = int(rng.choice([3, 6, 14, 100]))
    lanes = []
    for _ in range(E):
        c, s, b = chip_smoke.dense_fuzz_tables(
            np, rng, n=n, n_pad=n_pad, p=p, dtype=dtype_name, limit=limit,
            features=features, n_active=n_active)
        lanes.append((ref.NodeConst(**c), ref.NodeState(**s),
                      ref.PlacementBatch(**b)))
    return [_stack([ln[k] for ln in lanes]) for k in range(3)]


FUZZ = {
    "plain": (),
    "even_spreads": ("spreads", "low_score"),
    "target_spreads": ("targets", "affinity"),
    "distinct_property": ("dp",),
    "devices": ("devices", "affinity"),
    "cores": ("cores",),
    "cores_nonuniform": ("cores", "nonuniform"),
    "ports": ("ports",),
    "distinct_tg": ("distinct", "low_score"),
    "distinct_job": ("distinct", "job_level"),
    "penalties": ("penalties", "affinity", "low_score"),
    "nonuniform": ("nonuniform",),
    "scarce": ("scarce",),
    "everything": chip_smoke.DENSE_FEATURES[1:],
}


@pytest.mark.parametrize("dtype_name", ["float32", "float64"])
@pytest.mark.parametrize("world", sorted(FUZZ))
def test_fuzz_matches_jax(world, dtype_name):
    const, init, batch = _fuzz_lanes(
        sorted(FUZZ).index(world), FUZZ[world], dtype_name)
    want, got = _solve_both(const, init, batch, spread_alg=False,
                            dtype_name=dtype_name)
    assert_dense_equal(want, got, dtype_name)
    assert (got.chosen.numpy() >= 0).any()


@pytest.mark.parametrize("dtype_name", ["float32", "float64"])
@pytest.mark.parametrize("world", ["plain", "everything"])
def test_fuzz_spread_algorithm_matches_jax(world, dtype_name):
    """The worst-fit scoring (spread_alg) of the same worlds."""
    const, init, batch = _fuzz_lanes(
        100 + sorted(FUZZ).index(world), FUZZ[world], dtype_name)
    want, got = _solve_both(const, init, batch, spread_alg=True,
                            dtype_name=dtype_name)
    assert_dense_equal(want, got, dtype_name)


@pytest.mark.parametrize("dtype_name", ["float32", "float64"])
@pytest.mark.parametrize("fast", [False, True])
def test_wide_world_takes_both_fast_t_branches(fast, dtype_name):
    """N = 4,096 > 2 * FAST_T, so the reference's step runs its FAST_T
    shortcut: with only 5 feasible nodes among the first 1,024 positions
    it must take the full pass (fewer than ``limit`` counted options
    there), with them feasible the shortcut. The port always runs the
    full pass; the outcome is the same."""
    n = n_pad = 4096
    assert n > 2 * ref.FAST_T
    const, init, batch = _fuzz_lanes(7 + fast, ("spreads",), dtype_name,
                                     E=2, n=n, n_pad=n_pad, p=12, limit=14)
    if not fast:
        const.feasible[:, 5:ref.FAST_T] = False
    counted_front = const.feasible[:, :ref.FAST_T].sum(axis=1)
    assert ((counted_front >= 14) == fast).all()
    want, got = _solve_both(const, init, batch, spread_alg=False,
                            dtype_name=dtype_name)
    assert_dense_equal(want, got, dtype_name)
    assert (got.chosen.numpy() >= ref.FAST_T).any() != fast


@pytest.mark.parametrize("dtype_name", ["float32", "float64"])
def test_capacity_runs_out_mid_scan(dtype_name):
    """A lane whose nodes fill up before its placements end: later
    steps yield nothing (n_yielded 0, score -inf, chosen -1)."""
    const, init, batch = _fuzz_lanes(11, ("scarce",), dtype_name, E=2,
                                     n=6, n_pad=64, p=40, limit=3)
    want, got = _solve_both(const, init, batch, spread_alg=False,
                            dtype_name=dtype_name)
    assert_dense_equal(want, got, dtype_name)
    ny = got.n_yielded.numpy()
    assert (ny[:, -1] == 0).all() and (ny[:, 0] > 0).all()
    assert np.isneginf(got.scores.numpy()[:, -1]).all()


# --------------------------------------------------------------------------
# lanes the reference packs from scheduler worlds

def _fleet(rng, n, kind):
    nodes = []
    for i in range(n):
        if kind == "gpu" and rng.random() < 0.7:
            node = mock.gpu_node(count=rng.choice([1, 2, 4]))
        else:
            node = mock.node()
        k = rng.choice([2, 4, 8])
        node.node_resources.cpu.cpu_shares = k * 1000
        node.node_resources.cpu.total_core_count = k
        node.node_resources.cpu.reservable_cores = list(range(k))
        node.attributes["cpu.numcores"] = str(k)
        node.node_resources.memory.memory_mb = rng.choice([4096, 8192, 16384])
        node.meta["rack"] = f"r{i % 4}"
        node.id = f"dense-node-{i:04d}"
        node.compute_class()
        nodes.append(node)
    return nodes


def _job(kind, rng):
    job = mock.job(id=f"dense-{kind}")
    tg = job.task_groups[0]
    tg.count = 6
    task = tg.tasks[0]
    task.resources.cpu = rng.choice([250, 500, 1000])
    if kind == "dp_job":
        job.constraints = list(job.constraints) + [
            Constraint(l_target="${meta.rack}", r_target="2",
                       operand="distinct_property")]
    elif kind == "dp_tg":
        tg.constraints = [Constraint(l_target="${attr.cpu.numcores}",
                                     operand="distinct_property")]
        tg.count = 3
    elif kind == "devices":
        task.resources.devices = [DeviceRequest(
            name="gpu", count=1, affinities=[
                Affinity(l_target="${device.attr.cuda_cores}",
                         r_target="3584", operand=">=", weight=50)])]
    elif kind == "cores":
        task.resources.cores = 2
    elif kind == "ports_distinct":
        # one reserved core keeps the lane dense
        task.resources.cores = 1
        tg.networks = [NetworkResource(
            reserved_ports=[Port(label="admin", value=8080)],
            dynamic_ports=[Port(label="http")])]
        tg.constraints = [Constraint(operand="distinct_hosts")]
    elif kind == "distinct_job":
        task.resources.cores = 1
        job.constraints = list(job.constraints) + [
            Constraint(operand="distinct_hosts")]
    elif kind == "wide_spread":
        # count >= 126: the window max(count, 100) outgrows the 128-slot
        # wave buffer, so the lane is dense
        tg.count = 140
        task.resources.cpu = 100
        task.resources.memory_mb = 64
        tg.spreads = [Spread(attribute="${meta.rack}", weight=50),
                      Spread(attribute="${node.datacenter}", weight=25,
                             spread_target=[SpreadTarget("dc1", 100)])]
    return job


REF_WORLDS = ("dp_job", "dp_tg", "devices", "cores", "ports_distinct",
              "distinct_job", "wide_spread")


@functools.lru_cache(maxsize=None)
def _reference_lane(kind):
    rng = random.Random(REF_WORLDS.index(kind))
    h = Harness()
    nodes = _fleet(rng, 24, "gpu" if kind == "devices" else "plain")
    for node in nodes:
        h.state.upsert_node(node)
    job = _job(kind, rng)
    h.state.upsert_job(job)
    tg = job.task_groups[0]
    plan = Plan(eval_id=f"dense-eval-{kind:>24}", priority=50, job=job)
    ctx = EvalContext(h.state.snapshot(), plan)
    places = [AllocPlaceResult(name=f"{job.id}.{tg.name}[{k}]",
                               task_group=tg) for k in range(tg.count)]
    svc = TpuPlacementService(ctx, job, batch_mode=False, spread_alg=False)
    lane = svc.pack(tg, places, nodes)
    assert lane is not None and not lane.wavefront_ok()
    return lane


@pytest.mark.parametrize("dtype_name", ["float32", "float64"])
@pytest.mark.parametrize("kind", REF_WORLDS)
def test_reference_packed_lanes_match(kind, dtype_name):
    """Lanes packed by TpuPlacementService.pack, carried across with
    lane_from_reference, through the port's fuse-free dense wrapper."""
    lane = _reference_lane(kind)
    const, init, batch = (_cast(t, dtype_name)
                          for t in (lane.const, lane.init, lane.batch))
    want = ref.solve_placements(const, init, batch, spread_alg=False,
                                dtype_name=dtype_name)
    port = lane_from_reference(const, init, batch, lane.order,
                               dtype_name=dtype_name, device="cpu")
    got = dense.solve_placements(
        *(_stack([t]) for t in (port.const, port.init, port.batch)),
        spread_alg=False, dtype_name=dtype_name, device="cpu")
    got = dense.DenseOut(got.chosen[0], got.scores[0], got.n_yielded[0],
                         port_bp.NodeState(*(t[0] for t in got.state)))
    assert_dense_equal(want, got, dtype_name)
    assert (got.chosen.numpy() >= 0).sum() >= 2


def test_wrapper_takes_plain_version_on_cpu_and_needs_a_card_by_default():
    const, init, batch = _fuzz_lanes(3, ("dp", "cores"), "float64", E=2)
    tables = [port_bp_tree(t) for t in (const, init, batch)]
    before = kernels.DENSE_SCAN.launches
    c, s, b = dense.lane_tensors(*tables, dtype_name="float64",
                                 device=torch.device("cpu"))
    got = dense.dense_scan(c, s, b, spread_alg=False)
    want = dense.dense_scan_plain(c, s, b, spread_alg=False)
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g, w)
    assert kernels.DENSE_SCAN.launches == before
    # the wrapper leaves its input state alone
    np.testing.assert_array_equal(s.used_cpu.numpy(), init.used_cpu)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            dense.solve_placements(*tables, spread_alg=False)
    with pytest.raises(TypeError):
        dense.dense_scan(c._replace(cpu_cap=c.cpu_cap.float()), s, b,
                         spread_alg=False)
    with pytest.raises(ValueError):
        dense.dense_scan(c, s, b._replace(limit=b.limit[:, :3]),
                         spread_alg=False)
