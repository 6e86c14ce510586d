"""The LP tier (tpu-lpq) and the cross-lane fixpoint, held against the JAX
package on the CPU.

  * lp_relax_plain equals nomad_tpu.solver.lpq._lp_program bit for bit in
    X and mu (assert_array_equal), on seeded fuzz with rows that have no
    feasible node, inactive padding lanes, nodes with zero free capacity
    and oversubscribed queues; lp_temperatures equals the JAX
    expression's bits.
  * The host half exactly: the reference's X and mu, captured from its
    _lp_program, are fed to the port's _solve_lp_group through lp_relax,
    on the reference's own tests/test_lpq.py worlds packed by its
    TpuPlacementService; chosen, n_yielded and the ledger equal, scores
    within rtol 1e-12.
  * End to end: the port's solve_queue (plain LP on the CPU) against the
    reference's on the same worlds, plus a generation that mixes
    LP-ineligible lanes (spread, static port, penalty) riding
    fuse_and_solve and the fixpoint.
  * _cross_lane_fixpoint against the reference's, LpqBarrier with
    threads, and preemption lanes packed from structs, whose repair
    evicts through the port's Preemptor.

Every reference solve is pinned to the single-device program
(NOMAD_TPU_MESH=0; conftest gives the reference eight virtual devices).
"""
import threading

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from nomad_tpu import mock
from nomad_tpu.scheduler import Harness
from nomad_tpu.scheduler.context import EvalContext
from nomad_tpu.scheduler.reconcile import AllocPlaceResult
from nomad_tpu.solver import batch as ref_batch
from nomad_tpu.solver import guard
from nomad_tpu.solver import lpq as ref_lpq
from nomad_tpu.solver.service import TpuPlacementService
from nomad_tpu.structs import (
    NetworkResource, Plan, Port, Spread, SpreadTarget)

from nomad_tpu_torch.carry import lane_from_reference
from nomad_tpu_torch.solver import batch, lpq
from nomad_tpu_torch.tensor.pack import NodeMatrix

from torch_sanitizers import armed

# the suite runs under the port's sanitizers (tests/torch_sanitizers.py)
_torch_sanitizers = armed("jitcheck", "statecheck")

# One intra-op thread: the port's CPU tensors are small, and the test
# run already keeps one xdist worker busy per core.
torch.set_num_threads(1)

@pytest.fixture(autouse=True)
def single_device_reference(monkeypatch):
    monkeypatch.setenv("NOMAD_TPU_MESH", "0")
    guard._reset_for_tests()
    ref_lpq._reset_for_tests()
    lpq._reset_for_tests()
    yield
    guard._reset_for_tests()


# --------------------------------------------------------------------------
# 1. the relaxation: plain version vs the JAX program

def _lp_case(seed, L, N, *, over):
    """chip_smoke's generator (the inputs the kernel is held to on the
    card): the last two lanes inactive padding, lane 1 with no feasible
    node, nodes with no free cpu, and with ``over`` a queue asking for
    more than the fleet holds, so the prices rise."""
    return chip_smoke.lp_fuzz_inputs(np, np.random.default_rng(seed), L, N,
                                     over=over)


@pytest.mark.parametrize("steps", [4, 48])
@pytest.mark.parametrize("N", [64, 256, 1024])
@pytest.mark.parametrize("L", [8, 16])
def test_lp_relax_plain_matches_jax_bit_for_bit(L, N, steps):
    for seed, over in ((L + N + steps, False), (L + N + steps + 1, True)):
        inputs = _lp_case(seed, L, N, over=over)
        X_ref, mu_ref = ref_lpq._lp_program(L, N, steps)(*inputs)
        temps = lpq.lp_temperatures(steps)
        X, mu = lpq.lp_relax(*(torch.from_numpy(a)
                               for a in inputs + (temps,)))
        np.testing.assert_array_equal(X.numpy(), np.asarray(X_ref))
        np.testing.assert_array_equal(mu.numpy(), np.asarray(mu_ref))
        if over:
            assert float(mu.max()) > 0.0
        # the row without a feasible node and the padding lanes place
        # nothing
        assert not X[1].any() and not X[L - 2:].any()


@pytest.mark.parametrize("steps", [4, 5, 16, 47, 48, 64, 100])
def test_lp_temperatures_match_the_traced_anneal(steps):
    import jax.numpy as jnp

    def anneal(t):
        frac = t.astype(jnp.float32) / max(steps - 1, 1)
        return 0.25 * (0.02 / 0.25) ** frac

    want = np.asarray(jax.jit(anneal)(jnp.arange(steps)))
    got = lpq.lp_temperatures(steps)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_lp_relax_checks_its_inputs():
    V, feas, ask, pcount, free, active = (
        torch.from_numpy(a) for a in _lp_case(0, 8, 64, over=False))
    temps = torch.from_numpy(lpq.lp_temperatures(4))
    with pytest.raises(TypeError, match="float32"):
        lpq.lp_relax(V.double(), feas, ask, pcount, free, active, temps)
    with pytest.raises(ValueError, match="lane bucket"):
        lpq.lp_relax(V[:7], feas[:7], ask[:7], pcount[:7], free,
                     active[:7], temps)
    with pytest.raises(ValueError, match="power of two"):
        lpq.lp_relax(V[:, :48], feas[:, :48], ask, pcount, free[:48],
                     active, temps)
    with pytest.raises(ValueError, match="shape"):
        lpq.lp_relax(V, feas, ask, pcount, free[:32], active, temps)
    with pytest.raises(ValueError, match="meta"):
        lpq.lp_relax(V.to("meta"), feas, ask, pcount, free, active, temps)


# --------------------------------------------------------------------------
# the reference's own worlds (tests/test_lpq.py), packed by its service

def _fleet(n_nodes, cpu, mem, prefix):
    h = Harness()
    nodes = []
    for i in range(n_nodes):
        n = mock.node()
        n.id = f"{prefix}-{i:04d}"
        n.node_resources.cpu.cpu_shares = cpu
        n.node_resources.memory.memory_mb = mem
        n.meta["rack"] = f"r{i % 3}"
        n.compute_class()
        nodes.append(n)
        h.state.upsert_node(n)
    return h, nodes


def _pack(h, nodes, job, tg, *, priority=50, idx=0, penalty=None):
    """One reference lane of ``tg`` (count placements) from a fresh
    snapshot of ``h``; returns (lane, plan)."""
    snap = h.state.snapshot()
    plan = Plan(eval_id=f"lpq-eval-{job.id}-{tg.name}-{idx:08d}",
                priority=priority, job=job)
    ctx = EvalContext(snap, plan)
    places = [AllocPlaceResult(name=f"{job.id}.{tg.name}[{k}]",
                               task_group=tg) for k in range(tg.count)]
    svc = TpuPlacementService(ctx, job, batch_mode=False, spread_alg=False)
    lane = svc.pack(tg, places, nodes, penalty)
    assert lane is not None
    return lane, plan


def _queue(h, nodes, n_jobs, per_eval, tag):
    lanes = []
    for i in range(n_jobs):
        job = mock.job(id=f"{tag}-{i}")
        job.task_groups[0].count = per_eval
        h.state.upsert_job(job)
        lanes.append(_pack(h, nodes, job, job.task_groups[0], idx=i))
    return lanes


def world_coalesced():
    """test_lpq.py:165: 4 jobs x 3 on 8 nodes of 4,000 MHz / 8,192 MB."""
    h, nodes = _fleet(8, 4000, 8192, "lpq-node")
    return [_queue(h, nodes, 4, 3, "lpq-e2e")]


def world_oversubscribed():
    """test_lpq.py:193: 6 jobs x 2 onto two 2,200 MHz nodes (4 allocs
    each): the rounding collides, repairs and failures occur."""
    h, nodes = _fleet(2, 2200, 4096, "tight")
    return [_queue(h, nodes, 6, 2, "lpq-press")]


def world_two_task_groups():
    """test_lpq.py:229: one job with two task groups of 2 on two
    1,100 MHz nodes, one generation per task group on one ledger."""
    import copy

    h, nodes = _fleet(2, 1100, 4096, "lpq-node")
    job = mock.job(id="lpq-two-tg")
    tg1 = job.task_groups[0]
    tg1.count = 2
    tg2 = copy.deepcopy(tg1)
    tg2.name = "second"
    job.task_groups.append(tg2)
    h.state.upsert_job(job)
    return [[_pack(h, nodes, job, tg1)], [_pack(h, nodes, job, tg2)]]


WORLDS = {"coalesced": world_coalesced,
          "oversubscribed": world_oversubscribed,
          "two_task_groups": world_two_task_groups}


def _carry(pairs):
    """Port lanes for reference (lane, plan) pairs; lanes packed from one
    reference NodeMatrix share one port NodeMatrix."""
    matrices = {}
    out = []
    for lane, plan in pairs:
        m = lane.matrix
        pm = matrices.get(id(m))
        if pm is None:
            pm = matrices[id(m)] = NodeMatrix(
                n_real=m.n_real, n_pad=m.n_pad, node_ids=list(m.node_ids),
                cpu_cap=np.asarray(m.cpu_cap), mem_cap=np.asarray(m.mem_cap),
                disk_cap=np.asarray(m.disk_cap),
                dyn_free=np.asarray(m.dyn_free), valid=np.asarray(m.valid))
        out.append(lane_from_reference(
            lane.const, lane.init, lane.batch, lane.order,
            dtype_name=lane.dtype_name, spread_alg=lane.spread_alg,
            node_ids=list(m.node_ids), matrix=pm,
            plan_priority=plan.priority,
            plan_has_stops=bool(plan.node_update or plan.node_preemptions),
            device="cpu"))
    return out


def _assert_results_equal(want, got):
    assert len(want) == len(got)
    for rw, rg in zip(want, got):
        np.testing.assert_array_equal(rg[0], rw[0])
        np.testing.assert_array_equal(rg[2], rw[2])
        np.testing.assert_allclose(rg[1], rw[1], rtol=1e-12)


def _assert_ledgers_equal(want, got):
    assert sorted(want) == sorted(got)
    for nid in want:
        np.testing.assert_array_equal(np.asarray(got[nid], dtype=float),
                                      np.asarray(want[nid], dtype=float),
                                      err_msg=nid)


# --------------------------------------------------------------------------
# 2. the host half, exactly, with the reference's X and mu injected

@pytest.mark.parametrize("name", sorted(WORLDS))
def test_solve_lp_group_with_injected_relaxation_matches_reference(
        name, monkeypatch):
    captured = []
    real_program = ref_lpq._lp_program

    def capturing_program(L_pad, N, steps):
        prog = real_program(L_pad, N, steps)

        def run(*args):
            X, mu = prog(*args)
            captured.append(([np.array(a) for a in args],
                             np.array(X), np.array(mu)))
            return X, mu
        return run

    monkeypatch.setattr(ref_lpq, "_lp_program", capturing_program)

    def injected(V, feas, ask, pcount, free, active, temps):
        args, X, mu = captured.pop(0)
        for got, want in zip((V, feas, ask, pcount, free, active), args):
            np.testing.assert_array_equal(got.numpy(), want)
        assert temps.shape == (ref_lpq.lpq_steps(),)
        return torch.from_numpy(X), torch.from_numpy(mu)

    monkeypatch.setattr(lpq, "lp_relax", injected)
    ref_ledger, port_ledger = {}, {}
    for gen in WORLDS[name]():
        want = ref_lpq._solve_lp_group([l for l, _ in gen], ref_ledger)
        got = lpq._solve_lp_group(_carry(gen), port_ledger, device="cpu")
        assert not captured
        _assert_results_equal(want, got)
        _assert_ledgers_equal(ref_ledger, port_ledger)
    stats, ref_stats = lpq.lpq_stats(), ref_lpq.lpq_stats()
    for k in ("placements", "repairs", "failed", "quality_delta",
              "frag_delta"):
        assert stats[k] == ref_stats[k], k
    if name == "oversubscribed":
        assert stats["repairs"] >= 1 and stats["failed"] >= 1
        assert stats["placements"] == 8


# --------------------------------------------------------------------------
# 3. end to end: solve_queue with the plain LP on the CPU

def _mixed_generation():
    """Six LP lanes plus a spread lane, a static-port lane and a penalty
    lane (all three LP-ineligible: fuse_and_solve and the fixpoint), on
    one fleet of 12 nodes; the LP lanes run first so the greedy lanes are
    charged against the capacity the LP committed."""
    h, nodes = _fleet(12, 2200, 4096, "mixed")
    pairs = _queue(h, nodes, 6, 3, "mixed-lp")
    spread = mock.job(id="mixed-spread")
    stg = spread.task_groups[0]
    stg.count = 4
    stg.spreads = [Spread(attribute="${meta.rack}", weight=50,
                          spread_target=[SpreadTarget("r0", 50)])]
    static = mock.job(id="mixed-static")
    ptg = static.task_groups[0]
    ptg.count = 3
    ptg.networks = [NetworkResource(
        reserved_ports=[Port(label="admin", value=8080)])]
    pen = mock.job(id="mixed-penalty")
    pen.task_groups[0].count = 3
    for job, prio in ((spread, 60), (static, 50), (pen, 40)):
        h.state.upsert_job(job)
    pairs.append(_pack(h, nodes, spread, stg, priority=60, idx=100))
    pairs.append(_pack(h, nodes, static, ptg, priority=50, idx=101))
    penalty = [{nodes[k].id} if k % 2 == 0 else None for k in range(3)]
    pairs.append(_pack(h, nodes, pen, pen.task_groups[0], priority=40,
                       idx=102, penalty=penalty))
    return [pairs]


@pytest.mark.parametrize("name", sorted(WORLDS) + ["mixed"])
def test_solve_queue_matches_reference(name):
    gens = _mixed_generation() if name == "mixed" else WORLDS[name]()
    ref_ledger, port_ledger = {}, {}
    for gen in gens:
        ref_lanes = [l for l, _ in gen]
        ports = _carry(gen)
        if name == "mixed":
            elig = [lpq.lp_lane_eligible(p) for p in ports]
            assert elig == [ref_lpq.lp_lane_eligible(l) for l in ref_lanes]
            assert elig == [True] * 6 + [False] * 3
        want = ref_lpq.solve_queue(ref_lanes, ref_ledger)
        got = lpq.solve_queue(ports, port_ledger, device="cpu")
        _assert_results_equal(want, got)
        _assert_ledgers_equal(ref_ledger, port_ledger)
    stats, ref_stats = lpq.lpq_stats(), ref_lpq.lpq_stats()
    for k in ("solves", "lanes_total", "placements", "repairs", "failed",
              "greedy_lanes", "quality_delta", "frag_delta"):
        assert stats[k] == ref_stats[k], k


# --------------------------------------------------------------------------
# 4. the cross-lane fixpoint

def _fixpoint_world():
    """Five wave lanes from one snapshot onto two 2,200 MHz nodes (4
    allocs each), all piling onto the same best-fit node: priority 70
    (3), 60 (3, its plan already stops an alloc: consumer-only), 50 (3),
    40 (3) and 30 (2). The priority-50 lane's conflicts re-solve onto the
    capacity left; the priority-40 and -30 lanes' re-solves find none and
    keep their original choices."""
    h, nodes = _fleet(2, 2200, 4096, "fix")
    pairs = []
    for i, (prio, count) in enumerate(((50, 3), (70, 3), (40, 3),
                                       (60, 3), (30, 2))):
        job = mock.job(id=f"fix-{prio}")
        job.task_groups[0].count = count
        h.state.upsert_job(job)
        lane, plan = _pack(h, nodes, job, job.task_groups[0], priority=prio,
                           idx=i)
        if prio == 60:
            plan.node_update[nodes[0].id] = [object()]
        pairs.append((lane, plan))
    return pairs


def test_cross_lane_fixpoint_matches_reference():
    pairs = _fixpoint_world()
    ref_lanes = [l for l, _ in pairs]
    ports = _carry(pairs)
    assert [p.plan_has_stops for p in ports] == [False] * 3 + [True, False]
    want = ref_batch.fuse_and_solve(ref_lanes)
    got = batch.fuse_and_solve(ports, device="cpu")
    _assert_results_equal(want, got)
    before = [np.array(r[0]) for r in got]
    want = [tuple(np.array(a) for a in r) for r in want]
    ref_ledger, port_ledger = {}, {}
    ref_batch._cross_lane_fixpoint(ref_lanes, want, ref_ledger)
    batch._cross_lane_fixpoint(ports, got, port_ledger, device="cpu")
    _assert_results_equal(want, got)
    _assert_ledgers_equal(ref_ledger, port_ledger)
    moved = [bool((b != r[0]).any()) for b, r in zip(before, got)]
    # the top lane keeps its picks, the consumer-only lane is never
    # re-solved, the priority-50 lane moves onto the capacity left
    assert moved[1] is False and moved[3] is False and moved[0] is True
    # the lowest lanes' re-solves found nothing: original choices kept
    np.testing.assert_array_equal(got[2][0], before[2])
    np.testing.assert_array_equal(got[4][0], before[4])
    assert all(f[0] >= 0 for f in port_ledger.values())


def test_cross_lane_fixpoint_switch(monkeypatch):
    pairs = _fixpoint_world()
    ports = _carry(pairs)
    got = batch.fuse_and_solve(ports, device="cpu")
    before = [tuple(np.array(a) for a in r) for r in got]
    monkeypatch.setenv("NOMAD_TPU_TORCH_BATCH_FIXPOINT", "0")
    ledger = {}
    batch._cross_lane_fixpoint(ports, got, ledger, device="cpu")
    assert ledger == {}
    _assert_results_equal(before, got)


# --------------------------------------------------------------------------
# 5. LpqBarrier

def _barrier_lanes(n):
    return _carry(world_coalesced()[0][:n])


def _run_threads(barrier, lanes, *, done=True, gens=1):
    out = [None] * len(lanes)

    def work(i):
        try:
            res = []
            for _ in range(gens):
                res.append(barrier.solve(lanes[i]))
            out[i] = res
        except Exception as e:  # noqa: BLE001 -- the test reads it
            out[i] = e
        finally:
            if done:
                barrier.done()

    ts = [threading.Thread(target=work, args=(i,)) for i in range(len(lanes))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts)
    return out


def test_barrier_rendezvous_dispatches_once(monkeypatch):
    lanes = _barrier_lanes(n=4)
    calls = []
    real = lpq.solve_queue

    def counting(ls, ledger, device=None):
        calls.append(len(ls))
        return real(ls, ledger, device=device)

    monkeypatch.setattr(lpq, "solve_queue", counting)
    hints = []
    barrier = lpq.LpqBarrier(4, plan_group_hint=hints.append, device="cpu")
    out = _run_threads(barrier, lanes)
    assert calls == [4] and hints == [4]
    want = real(lanes, {}, device="cpu")
    for (res,), w in zip(out, want):
        _assert_results_equal([w], [res])


def test_barrier_straggler_valve(monkeypatch):
    monkeypatch.setattr(lpq, "LPQ_BARRIER_TIMEOUT_S", 0.2)
    lanes = _barrier_lanes(n=2)
    calls = []
    real = lpq.solve_queue
    monkeypatch.setattr(lpq, "solve_queue", lambda ls, ledger, device=None: (
        calls.append(len(ls)) or real(ls, ledger, device=device)))
    # three participants, but the third never arrives nor finishes
    barrier = lpq.LpqBarrier(3, device="cpu")
    out = _run_threads(barrier, lanes, done=False)
    assert calls == [2]
    assert all(isinstance(r, list) and (r[0][0] >= 0).all() for r in out)


def test_barrier_error_reaches_every_waiter(monkeypatch):
    def boom(ls, ledger, device=None):
        raise RuntimeError("dispatch failed")

    monkeypatch.setattr(lpq, "solve_queue", boom)
    barrier = lpq.LpqBarrier(3, device="cpu")
    out = _run_threads(barrier, _barrier_lanes(n=3))
    assert all(isinstance(r, RuntimeError) and "dispatch failed" in str(r)
               for r in out)


def test_barrier_ledger_persists_across_generations():
    """Two threads, two generations each, on the two 1,100 MHz nodes of
    the two-task-group world (two allocs a node): the second generation
    sees the first one's commits, so nothing lands on a full node."""
    gens = world_two_task_groups()
    pairs = [gens[0][0], gens[1][0]]
    lanes = _carry(pairs)
    barrier = lpq.LpqBarrier(2, device="cpu")
    out = _run_threads(barrier, lanes, gens=2)
    per_node = {}
    for lane, res in zip(lanes, out):
        for chosen, _, _ in res:
            for pos in chosen[chosen >= 0]:
                nid = lane.node_ids[lane.order[pos]]
                per_node[nid] = per_node.get(nid, 0) + 1
    assert sorted(per_node.values()) == [2, 2]
    assert sum(int((c >= 0).sum()) for res in out for c, _, _ in res) == 4
    assert len(barrier._ledger) == 2


# --------------------------------------------------------------------------
# 6. preemption lanes, packed from structs

def test_lp_eligible_preemption_lane_raises():
    """Preemption lanes no longer raise: lanes packed from structs (the
    reference's TpuPlacementService, and the port's on the carried
    snapshot) solve through the LP tier, whose repair evicts with the
    port's Preemptor; chosen nodes, eviction rows and evicted alloc ids
    equal the reference's solve_queue."""
    import itertools
    import random

    from nomad_tpu.scheduler.context import EvalContext as RefContext
    from nomad_tpu.scheduler.reconcile import AllocPlaceResult as RefPlace
    from nomad_tpu.solver import service as ref_service
    from nomad_tpu.structs import ALLOC_CLIENT_RUNNING, Plan as RefPlan
    from nomad_tpu_torch.carry import (
        store_from_reference, struct_from_reference)
    from nomad_tpu_torch.scheduler.context import EvalContext as PortContext
    from nomad_tpu_torch.solver.service import (
        TpuPlacementService as PortService)
    from tests.test_torch_service import assert_lanes_equal

    rng = random.Random(3)
    mock._counter = itertools.count()
    h = Harness()
    nodes = []
    for i in range(6):
        node = mock.node()
        node.id = f"lp-node-{i:02d}"
        h.state.upsert_node(node)
        nodes.append(node)
        for k in range(2):
            j = mock.job(priority=rng.choice([10, 20, 30]))
            j.id = f"lp-filler-{i}-{k}"
            j.task_groups[0].tasks[0].resources.cpu = 1800
            j.task_groups[0].tasks[0].resources.memory_mb = 512
            h.state.upsert_job(j)
            a = mock.alloc_for(j, node, index=k)
            a.client_status = ALLOC_CLIENT_RUNNING
            h.state.upsert_allocs([a])
    snap = h.state.snapshot()
    ready = snap.ready_nodes_in_pool("default")
    ref_lanes, port_lanes = [], []
    memo = {}
    store = store_from_reference(snap, memo)
    psnap = store.snapshot()
    pready = struct_from_reference(ready, memo)
    for e in range(3):
        job = mock.job(priority=70)
        job.id = f"lp-job-{e}"
        job.task_groups[0].count = 2 + e
        job.task_groups[0].tasks[0].resources.cpu = 1000
        job.task_groups[0].tasks[0].resources.memory_mb = 256
        tg = job.task_groups[0]
        plan = RefPlan(eval_id=f"lp-preempt-eval-{e:04d}", job=job,
                       priority=70)
        rsvc = ref_service.TpuPlacementService(
            RefContext(snap, plan), job, False, False, dtype="float64",
            preempt=True)
        places = [RefPlace(name=f"{job.id}.web[{i}]", task_group=tg)
                  for i in range(tg.count)]
        rl = rsvc.pack(tg, places, ready)
        pm = dict(memo)
        pjob = struct_from_reference(job, pm)
        psvc = PortService(
            PortContext(psnap, struct_from_reference(plan, pm)), pjob,
            False, False, preempt=True, device="cpu")
        pl = psvc.pack(pjob.task_groups[0], struct_from_reference(places, pm),
                       pready)
        assert_lanes_equal(rl, pl)
        assert lpq.lp_lane_eligible(pl) and ref_lpq.lp_lane_eligible(rl)
        ref_lanes.append(rl)
        port_lanes.append(pl)
    want = ref_lpq.solve_queue(ref_lanes, {})
    got = lpq.solve_queue(port_lanes, {}, device="cpu")
    n_evicted = 0
    for rl, pl, w, g in zip(ref_lanes, port_lanes, want, got):
        assert len(w) == len(g) == 4
        assert np.array_equal(w[0], g[0])
        assert np.array_equal(w[3], g[3])
        wm = rl.service.materialize(rl, *w)
        gm = pl.service.materialize(pl, *g)
        assert [[a.id for a in p.preempted_allocs or ()] for p in wm] == \
            [[a.id for a in p.preempted_allocs or ()] for p in gm]
        n_evicted += sum(len(p.preempted_allocs or ()) for p in gm)
    assert n_evicted > 0
    assert lpq.lpq_stats()["preempt_evictions"] == n_evicted


def test_solve_queue_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    lanes = _barrier_lanes(n=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        lpq.solve_queue(lanes, {})
