"""The port's stack arena (nomad_tpu_torch/solver/batch.py) against the
reference's (nomad_tpu/solver/batch.py _StackArena) on the CPU:

  * the reference's arena scenarios (tests/test_pack_cache.py) for the
    port: bounds, reuse and alloc counters, the kill switch, pad-fill
    skips that stay inert, a shrinking e_real, and pooled buffers frozen
    in the free list;
  * the padding rows: over generations of different sizes both packages'
    fuse_lanes stack byte-identical buffers, stale padding rows included;
  * the four-generation residency sequence of tests/test_torch_resident.py
    at group sizes off the E buckets (3, 5, 7): each generation through
    both packages' solve_groups (arena entries released after the
    dispatch, as the reference releases them), equal decisions and equal
    resident-set counters after every generation.
"""
import copy

import numpy as np
import pytest
import torch

from nomad_tpu import mock
from nomad_tpu.solver import batch as ref_batch
from nomad_tpu.solver import constcache

from nomad_tpu_torch.carry import lane_from_reference
from nomad_tpu_torch.solver import batch, resident
from nomad_tpu_torch.tensor.pack import NodeMatrix, UsageState
from nomad_tpu_torch.solver.service import pack_lane_arrays

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv("NOMAD_TPU_MESH", "0")
    for mod in (batch, ref_batch):
        mod.arena_clear("test")
        mod._ARENA._stats.update(reuses=0, allocs=0, evictions=0,
                                 pad_fills_skipped=0)
    resident._reset_for_tests()
    constcache._reset_for_tests()
    yield
    batch.arena_clear("test")
    ref_batch.arena_clear("test")
    resident._reset_for_tests()
    constcache._reset_for_tests()


# ----------------------------------------------------------------------
# the reference's arena scenarios, on the port

def test_arena_bounds_and_kill_switch(monkeypatch):
    arena = batch._ARENA
    specs = {"t": [((4, 8), np.dtype(np.float64))]}
    e1, r1 = arena.acquire(("k1", 4, 8), specs)
    assert not r1
    arena.release(e1)
    e2, r2 = arena.acquire(("k1", 4, 8), specs)
    assert r2 and e2 is e1
    # a shape mismatch under the same key never reuses
    e3, r3 = arena.acquire(("k1", 4, 8),
                           {"t": [((4, 16), np.dtype(np.float64))]})
    assert not r3
    arena.release(e2)
    arena.release(e3)
    # the entry bound evicts the oldest free entries
    monkeypatch.setenv("NOMAD_TPU_TORCH_PACK_ARENA_ENTRIES", "1")
    held = [arena.acquire((f"k{i}", 1, 1),
                          {"t": [((2, 2), np.dtype(np.float64))]})[0]
            for i in range(3)]
    for ent in held:
        arena.release(ent)
    st = batch.arena_state()
    assert st["entries"] <= 1 and st["evictions"] >= 2
    # the MiB bound too
    monkeypatch.setenv("NOMAD_TPU_TORCH_PACK_ARENA_ENTRIES", "8")
    monkeypatch.setenv("NOMAD_TPU_TORCH_PACK_ARENA_MB", "0.0001")
    big, _ = arena.acquire(("big", 1, 1),
                           {"t": [((64, 64), np.dtype(np.float64))]})
    arena.release(big)
    assert batch.arena_state()["resident_bytes"] <= 105
    # kill switch: nothing pooled, fresh buffers each time
    monkeypatch.setenv("NOMAD_TPU_TORCH_PACK_ARENA", "0")
    e4, r4 = arena.acquire(("k1", 4, 8), specs)
    assert not r4
    arena.release(e4)
    e5, r5 = arena.acquire(("k1", 4, 8), specs)
    assert not r5 and e5 is not e4
    arena.release(e5)
    assert not batch.arena_state()["enabled"]


def test_pooled_buffers_are_frozen_until_checked_out():
    arena = batch._ARENA
    specs = {"t": [((2, 3), np.dtype(np.float32))]}
    ent, _ = arena.acquire(("f", 2, 3), specs)
    ent.trees["t"][0][:] = 1.0
    arena.release(ent)
    with pytest.raises(ValueError):
        ent.trees["t"][0][0, 0] = 2.0
    again, reused = arena.acquire(("f", 2, 3), specs)
    assert reused and again is ent
    again.trees["t"][0][0, 0] = 2.0          # writable once checked out
    assert batch.arena_state()["in_use"] == 1
    arena.release(again)
    assert batch.arena_state()["in_use"] == 0


def _matrix(n=12, n_pad=64):
    return NodeMatrix(
        n_real=n, n_pad=n_pad, node_ids=[f"n{i}" for i in range(n)],
        cpu_cap=np.r_[np.full(n, 4000.0), np.zeros(n_pad - n)],
        mem_cap=np.r_[np.full(n, 8192.0), np.zeros(n_pad - n)],
        disk_cap=np.r_[np.full(n, 102400.0), np.zeros(n_pad - n)],
        dyn_free=np.full(n_pad, 100, dtype=np.int32),
        valid=np.arange(n_pad) < n)


def _lanes(k, lo=0, count=4):
    matrix = _matrix()
    n_pad = matrix.n_pad
    z = np.zeros(n_pad)
    zi = np.zeros(n_pad, dtype=np.int32)
    usage = UsageState(z, z, z, zi, zi, zi)
    return [pack_lane_arrays(matrix, usage, np.ones(n_pad, dtype=bool),
                             ask=(500.0, 256.0, 150.0), count=count,
                             n_places=count, eval_id=f"arena-{lo + i:04d}",
                             state_index=1, device="cpu")
            for i in range(k)]


def test_warm_dispatch_reuses_arena_and_matches_kill_switch(monkeypatch):
    lanes = _lanes(3)
    s0 = batch.arena_state()
    first = batch.fuse_and_solve(lanes, device="cpu")
    s1 = batch.arena_state()
    assert s1["allocs"] == s0["allocs"] + 1
    second = batch.fuse_and_solve(lanes, device="cpu")
    s2 = batch.arena_state()
    assert s2["reuses"] == s1["reuses"] + 1
    assert s2["allocs"] == s1["allocs"], "the warm path allocated buffers"
    assert s2["in_use"] == 0 and s2["entries"] == 1
    for a, b in zip(first, second):
        assert (a[0] == b[0]).all() and (a[2] == b[2]).all()
    monkeypatch.setenv("NOMAD_TPU_TORCH_PACK_ARENA", "0")
    off = batch.fuse_and_solve(lanes, device="cpu")
    for a, b in zip(first, off):
        assert (a[0] == b[0]).all()
    assert batch.arena_state()["entries"] == 1


def test_padding_rows_skipped_but_masked_inert():
    """With e_pad > e_real a reused entry skips the padding-row fill
    (pad_fills_skipped climbs) and results stay those of each lane's solo
    dispatch; shrinking e_real on a reused entry leaves last generation's
    real lanes in the rows past it, inactive."""
    lanes = _lanes(3, lo=20)
    solo = [batch.fuse_and_solve([ln], device="cpu")[0] for ln in lanes]
    res1 = batch.fuse_and_solve(lanes, device="cpu", e_pad_hint=8)
    s1 = batch.arena_state()
    res2 = batch.fuse_and_solve(lanes, device="cpu", e_pad_hint=8)
    s2 = batch.arena_state()
    assert s2["pad_fills_skipped"] == s1["pad_fills_skipped"] + 1
    for res in (res1, res2):
        for got, want in zip(res, solo):
            np.testing.assert_array_equal(got[0], want[0])
    res3 = batch.fuse_and_solve(lanes[:2], device="cpu", e_pad_hint=8)
    for got, want in zip(res3, solo[:2]):
        np.testing.assert_array_equal(got[0], want[0])
    # the group the arena left: rows 2.. hold earlier lanes, inactive
    g = batch.fuse_lanes(lanes[:2], e_pad_hint=8)[0]
    assert g.e_pad == 8 and not g.batch.active[2:].any()
    np.testing.assert_array_equal(g.init.used_cpu[2],
                                  np.asarray(lanes[2].init.used_cpu))
    batch.release_groups([g])


# ----------------------------------------------------------------------
# against the reference: the stacked buffers and the resident counters

N_NODES = 48


def _world(n_plain, n_spread):
    """A reference scheduler world (a fleet partly filled by a
    priority-20 job's allocs through real upsert_allocs) and lanes the
    reference packs: ``n_plain`` plain lanes (one wave group) and
    ``n_spread`` spread lanes at count 140 (one dense group)."""
    from nomad_tpu.scheduler import Harness
    from nomad_tpu.scheduler.context import EvalContext
    from nomad_tpu.scheduler.reconcile import AllocPlaceResult
    from nomad_tpu.solver.service import TpuPlacementService
    from nomad_tpu.structs import Plan, Spread

    h = Harness()
    nodes = []
    for i in range(N_NODES):
        n = mock.node()
        n.id = f"arena-node-{i:04d}"
        n.node_resources.cpu.cpu_shares = (2000, 4000, 8000)[i % 3]
        n.node_resources.memory.memory_mb = (4096, 8192, 16384)[i % 3]
        n.meta["rack"] = f"r{i % 5}"
        n.compute_class()
        nodes.append(n)
        h.state.upsert_node(n)
    filler = mock.job(id="arena-filler")
    filler.priority = 20
    h.state.upsert_job(filler)
    h.state.upsert_allocs([mock.alloc_for(filler, nodes[k], index=k)
                           for k in range(0, N_NODES, 2)])
    snap = h.state.snapshot()
    specs = ([("plain", 16 + 2 * i) for i in range(n_plain)]
             + [("spread", 140)] * n_spread)
    lanes = []
    for i, (kind, count) in enumerate(specs):
        job = mock.job(id=f"arena-job-{i}")
        tg = job.task_groups[0]
        tg.count = count
        if kind == "spread":
            tg.tasks[0].resources.cpu = 100
            tg.tasks[0].resources.memory_mb = 64
            tg.spreads = [Spread(attribute="${meta.rack}", weight=50)]
        h.state.upsert_job(job)
        plan = Plan(eval_id=f"arena-eval-{i:026d}", priority=50, job=job)
        ctx = EvalContext(snap, plan)
        places = [AllocPlaceResult(name=f"{job.id}.{tg.name}[{k}]",
                                   task_group=tg) for k in range(count)]
        svc = TpuPlacementService(ctx, job, batch_mode=False,
                                  spread_alg=False)
        lane = svc.pack(tg, places, nodes)
        assert lane is not None and lane.delta_src is not None
        lanes.append(lane)
    assert [ln.wavefront_ok() for ln in lanes] == (
        [True] * n_plain + [False] * n_spread)
    return h, nodes, filler, lanes


def _carry(lanes):
    return [lane_from_reference(
        ln.const, ln.init, ln.batch, ln.order, dtype_name=ln.dtype_name,
        spread_alg=ln.spread_alg, node_ids=ln.matrix.node_ids,
        ptab=ln.ptab, pinit=ln.pinit, table_version=ln.table_version,
        delta_src=ln.delta_src, device="cpu") for ln in lanes]


def _same_bytes(a, b):
    """Equal bytes; an empty table only by shape (the carry gives 0-size
    floating fields the lane dtype)."""
    a, b = np.asarray(a), np.asarray(b)
    if a.size == 0 or b.size == 0:
        return a.shape == b.shape
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.tobytes() == b.tobytes())


def test_stacked_buffers_match_reference_across_generations():
    """Generations of 7, 5 and 3 lanes of one fuse key: each generation's
    stacked trees (padding rows included, which hold earlier
    generations' lanes once the entry is reused) equal the reference's
    byte for byte."""
    _, _, _, lanes = _world(7, 0)
    port_lanes = _carry(lanes)
    for k in (7, 5, 3, 7):
        rg, = ref_batch.fuse_lanes(lanes[:k])
        pg, = batch.fuse_lanes(port_lanes[:k])
        assert (pg.e_real, pg.e_pad) == (rg.e_real, rg.e_pad)
        assert pg.arena_reused == rg.arena_reused
        for tree in ("const", "init", "batch"):
            for f, a, b in zip(type(getattr(pg, tree))._fields,
                               getattr(rg, tree), getattr(pg, tree)):
                assert _same_bytes(a, b), (k, tree, f)
        ref_batch._ARENA.release(rg.entry)
        batch.release_groups([pg])
    want, got = ref_batch.arena_state(), batch.arena_state()
    for key in ("reuses", "allocs", "evictions", "pad_fills_skipped",
                "entries", "in_use", "resident_bytes"):
        assert got[key] == want[key], key
    assert got["pad_fills_skipped"] > 0


STAT_KEYS = ("hits", "misses", "bytes_shipped_total", "bytes_saved_total",
             "delta_promotions", "delta_reuses", "delta_fallbacks",
             "delta_gap_fallbacks", "delta_size_fallbacks",
             "delta_bytes_total", "delta_touched_nodes_last",
             "resident_bytes", "chain_resident_bytes", "entries",
             "chain_entries")


def _charge(lanes, k, nodes_pos, ask):
    init = lanes[k].init
    for f, a in zip(("used_cpu", "used_mem", "used_disk"), ask):
        getattr(init, f)[nodes_pos] += a


def _set_token(lanes, store):
    for ln in lanes:
        ln.delta_src = (store, store.latest_index())


@pytest.mark.parametrize("n_plain", [3, 5, 7])
def test_generation_sequence_off_bucket_matches_reference(n_plain):
    """install -> reuse/hit -> promote -> gap with a wave group of
    ``n_plain`` lanes and a dense group of 3 (E buckets 4 or 8, so every
    group has padding rows): both packages' solve_groups, decisions
    equal, resident-set counters equal the reference's after every
    generation, every chain buffer equal to its frozen shadow."""
    h, nodes, filler, lanes = _world(n_plain, 3)
    lanes = [copy.copy(ln) for ln in lanes]
    for ln in lanes:
        ln.init = type(ln.init)(*(np.array(a) for a in ln.init))
    store = h.state
    seen = []

    def generation():
        ref_groups = ref_batch.fuse_lanes(lanes)
        assert sorted(g.e_real for g in ref_groups) == sorted((n_plain, 3))
        assert all(g.e_pad > g.e_real for g in ref_groups)
        want = ref_batch.solve_groups(lanes, ref_groups, use_mesh=False)
        port_lanes = _carry(lanes)
        got = batch.solve_groups(port_lanes, batch.fuse_lanes(port_lanes),
                                 device="cpu")
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g[0], w[0])
            np.testing.assert_array_equal(g[2], w[2])
            np.testing.assert_array_equal(g[1], w[1])
        st_w, st_g = constcache.stats(), resident.stats()
        for k in STAT_KEYS:
            assert st_g[k] == st_w[k], (k, st_g[k], st_w[k], len(seen))
        for buf, shadow in resident.chain_entries():
            assert _same_bytes(buf.numpy(), shadow)
        aw, ag = ref_batch.arena_state(), batch.arena_state()
        for k in ("reuses", "allocs", "pad_fills_skipped", "in_use"):
            assert ag[k] == aw[k], k
        seen.append(dict(st_g))

    generation()                                   # g1: cold
    store.upsert_allocs([mock.alloc_for(filler, nodes[1], index=900)])
    _set_token(lanes, store)
    generation()                                   # g2: reuse / hit
    assert seen[1]["delta_reuses"] > 0 and seen[1]["hits"] > 0
    assert batch.arena_state()["pad_fills_skipped"] >= 2
    store.upsert_allocs([mock.alloc_for(filler, nodes[k], index=910 + k)
                         for k in (3, 5)])
    _set_token(lanes, store)
    for k in (0, n_plain):                         # lane 0 of each group
        _charge(lanes, k, [3, 5], (100.0, 64.0, 150.0))
    generation()                                   # g3: promote
    assert seen[2]["delta_promotions"] > 0
    with store._lock:
        store._bump("allocs")
    _set_token(lanes, store)
    _charge(lanes, n_plain, [7], (100.0, 64.0, 150.0))
    generation()                                   # g4: gap
    assert seen[3]["delta_gap_fallbacks"] > 0
