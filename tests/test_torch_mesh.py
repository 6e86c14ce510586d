"""The port's mesh route (nomad_tpu_torch/parallel/mesh.py) against the
reference's mesh programs (nomad_tpu/parallel/mesh.py) on the CPU.

The reference runs its mesh on the 8 virtual XLA CPU devices conftest.py
sets up; the port runs a grid of 8 cells that are all the CPU (a grid is
a 2-D array of torch.devices, and one device may fill several cells).
Over every factorization of 8 cells, GRID:

  * mesh_solve (the node-sharded step's plain phases when the grid has
    more than one node column) equals the reference's mesh_solve_fn and
    the port's one-device solve_placements, bit for bit (chosen, scores,
    n_yielded) in float32 and float64, on the reference's varied world
    and on a fuzz world with spreads, distinct_property, devices,
    reserved cores, ports and penalties;
  * mesh_lpq gives the reference's mesh_lpq_fn's X and mu bit for bit;
  * mesh_delta_scatter_plain equals mesh_delta_scatter_fn byte for byte,
    with -0.0, NaN payloads and duplicated padding indices; the grouped
    mesh_delta_scatter (one payload upload and one coord_scatter_cells
    call per device) too, on 4 and 8 cells with sharded and replicated
    specs, updates on every cell's edges and k = 0;
  * the eval-sharded wave and windowed-preemption routes equal the
    unsharded ones;
  * pick_mesh picks the reference's grid over a sweep of (e, n, cells),
    and NOMAD_TPU_TORCH_MESH=0 refuses every grid;
  * four generations through both packages' fuse_and_solve with the mesh
    on (a dense group on a (4, 2) grid, a wave group eval-sharded over 8):
    equal decisions and equal resident-set counters, the per-shard pool
    and the grid's version chain included.
"""
import copy
import functools

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
import chip_smoke
from nomad_tpu import mock
from nomad_tpu.parallel import mesh as ref_mesh
from nomad_tpu.solver import batch as ref_batch
from nomad_tpu.solver import binpack as ref_bp
from nomad_tpu.solver import constcache

from nomad_tpu_torch.parallel import mesh
from nomad_tpu_torch.solver import batch, dense, lpq, resident
from nomad_tpu_torch.solver import binpack as port_bp

from torch_sanitizers import armed

# the suite runs under the port's sanitizers (tests/torch_sanitizers.py)
_torch_sanitizers = armed("jitcheck")

torch.set_num_threads(1)

GRID = [(8, 1), (4, 2), (2, 4), (1, 8)]
CELLS = ["cpu"] * 8


@pytest.fixture(autouse=True)
def _clean():
    resident._reset_for_tests()
    constcache._reset_for_tests()
    mesh._reset_for_tests()
    yield
    resident._reset_for_tests()
    constcache._reset_for_tests()


def _needs_8_devices():
    if jax.device_count() < 8:
        pytest.skip("needs the 8 virtual XLA devices of tests/conftest.py")


def _stack(trees):
    return type(trees[0])(*(np.stack([np.asarray(f) for f in fields])
                            for fields in zip(*trees)))


def _port_tree(tree):
    cls = {"NodeConst": port_bp.NodeConst, "NodeState": port_bp.NodeState,
           "PlacementBatch": port_bp.PlacementBatch}[type(tree).__name__]
    return cls(*(np.asarray(getattr(tree, f)) for f in cls._fields))


def _world(kind, dtype_name, seed):
    """E = 8 stacked reference lanes over N = 256 nodes, P = 16."""
    rng = np.random.default_rng(seed)
    if kind == "varied":
        lanes = [graft._varied_inputs(rng, 256, 16, dtype=dtype_name)
                 for _ in range(8)]
        lanes = [tuple(type(t)(*(np.asarray(a) for a in t)) for t in ln)
                 for ln in lanes]
    else:
        lanes = []
        for _ in range(8):
            c, s, b = chip_smoke.dense_fuzz_tables(
                np, rng, n=240, n_pad=256, p=16, dtype=dtype_name, limit=6,
                features=chip_smoke.DENSE_FEATURES[1:])
            lanes.append((ref_bp.NodeConst(**c), ref_bp.NodeState(**s),
                          ref_bp.PlacementBatch(**b)))
    return [_stack([ln[k] for ln in lanes]) for k in range(3)]


@functools.lru_cache(maxsize=None)
def _ref_single(dtype_name):
    return jax.jit(functools.partial(ref_bp.solve_eval_batch,
                                     spread_alg=False,
                                     dtype_name=dtype_name),
                   device=jax.devices()[0])


@pytest.mark.parametrize("world", ["varied", "fuzz"])
@pytest.mark.parametrize("dtype_name", ["float32", "float64"])
@pytest.mark.parametrize("e_par,n_par", GRID)
def test_mesh_solve_matches_reference_and_one_device(e_par, n_par,
                                                     dtype_name, world):
    _needs_8_devices()
    const, init, batch_t = _world(world, dtype_name, 100 + e_par)
    want = _ref_single(dtype_name)(const, init, batch_t)
    rmesh = ref_mesh.make_mesh(8, eval_parallel=e_par)
    with rmesh:
        s_c, s_i, s_b = ref_mesh.shard_solver_inputs(rmesh, const, init,
                                                     batch_t)
        ref_out = ref_mesh.mesh_solve_fn(rmesh, False, dtype_name)(
            s_c, s_i, s_b)
    grid = mesh.make_mesh(CELLS, eval_parallel=e_par)
    assert grid.shape == (e_par, n_par)
    ports = [_port_tree(t) for t in (const, init, batch_t)]
    got = mesh.mesh_solve(grid, *ports, spread_alg=False,
                          dtype_name=dtype_name)
    one = dense.solve_placements(*ports, spread_alg=False,
                                 dtype_name=dtype_name, device="cpu")
    for k in range(3):
        np.testing.assert_array_equal(got[k], np.asarray(ref_out[k]))
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
        np.testing.assert_array_equal(got[k], one[k].numpy())
    assert (got[0] >= 0).any()
    assert got[1].dtype == np.dtype(dtype_name)
    st = mesh.mesh_stats()
    assert st["dense_dispatches"] == 1
    assert (st["node_sharded_steps"] > 0) == (n_par > 1)


def test_node_sharded_cells_end_in_the_scan_state():
    """The node-sharded step on a (2, 4) grid, driven by hand: each row's
    cells, their usage slices assembled, end in the one-device scan's
    final state, and every cell of a row holds the same counts."""
    const, init, batch_t = _world("fuzz", "float64", 7)
    ports = [_port_tree(t) for t in (const, init, batch_t)]
    grid = mesh.make_mesh(CELLS, eval_parallel=2)
    s = mesh.shard_solver_inputs(grid, *ports)
    cast = dense.lane_casts("float64")
    rows = [[dense.ShardCell(*(mesh._cell_tree(t, i, j, cast)
                               for t in (s.const, s.init, s.batch)),
                             j=j, n_par=4, spread_alg=False)
             for j in range(4)] for i in range(2)]
    mesh.run_node_sharded(rows)
    ref = dense.solve_placements(*ports, spread_alg=False,
                                 dtype_name="float64", device="cpu")
    node_axis = {"dev_free": 3}
    for i, row in enumerate(rows):
        lanes = slice(4 * i, 4 * i + 4)
        np.testing.assert_array_equal(row[0].chosen.numpy(),
                                      ref.chosen[lanes].numpy())
        for f in port_bp.NodeState._fields:
            want = getattr(ref.state, f)[lanes]
            if f in ("spread_counts", "dp_counts"):
                for c in row:
                    assert torch.equal(getattr(c.state, f), want), f
                continue
            got = torch.cat([getattr(c.state, f) for c in row],
                            dim=node_axis.get(f, 1))
            assert torch.equal(got, want), f


@pytest.mark.parametrize("e_par,n_par", GRID)
def test_mesh_lpq_matches_reference(e_par, n_par):
    _needs_8_devices()
    from nomad_tpu.solver.lpq import _lp_program
    L, N, steps = 16, 256, 16
    rng = np.random.default_rng(200 + e_par)
    V = rng.standard_normal((L, N)).astype(np.float32)
    feas = rng.uniform(size=(L, N)) > 0.3
    ask = np.abs(rng.standard_normal((L, 3))).astype(np.float32)
    pcount = rng.integers(1, 4, L).astype(np.float32)
    free = (np.abs(rng.standard_normal((N, 3))) * 4.0).astype(np.float32)
    active = np.ones(L, dtype=bool)
    active[-1] = False
    X_ref, mu_ref = _lp_program(L, N, steps)(V, feas, ask, pcount, free,
                                             active)
    rmesh = ref_mesh.make_mesh(8, eval_parallel=e_par)
    with rmesh:
        s_in = ref_mesh.shard_lpq_inputs(rmesh, V, feas, ask, pcount, free,
                                         active)
        X_m, mu_m = ref_mesh.mesh_lpq_fn(rmesh, L, N, steps)(*s_in)
    grid = mesh.make_mesh(CELLS, eval_parallel=e_par)
    p_in, shipped = mesh.shard_lpq_inputs(grid, V, feas, ask, pcount, free,
                                          active)
    assert shipped == sum(a.nbytes for a in (V, feas, ask, pcount, free,
                                             active))
    X, mu = mesh.mesh_lpq(grid, p_in, lpq.lp_temperatures(steps))
    np.testing.assert_array_equal(X.numpy(), np.asarray(X_m))
    np.testing.assert_array_equal(mu.numpy(), np.asarray(mu_m))
    np.testing.assert_array_equal(X.numpy(), np.asarray(X_ref))
    assert np.isfinite(X.numpy()).all()


def _bytes_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


@pytest.mark.parametrize("dtype", ["float32", "float64", "int32", "bool"])
@pytest.mark.parametrize("e_par,n_par", GRID)
def test_mesh_delta_scatter_matches_reference(e_par, n_par, dtype):
    _needs_8_devices()
    from jax.sharding import NamedSharding, PartitionSpec
    rng = np.random.default_rng(11)
    shape, spec = (8, 2, 3, 256), mesh.ERGN       # a dev_free-like table
    if dtype == "bool":
        base = rng.uniform(size=shape) > 0.5
    else:
        base = (rng.standard_normal(shape) * 50).astype(dtype)
    idx = rng.choice(base.size, 45, replace=False).astype(np.int64)
    vals = base.reshape(-1)[idx].copy()
    if dtype.startswith("float"):
        vals[0] = -0.0
        bits = np.dtype("u%d" % base.itemsize)
        nan = np.array([np.nan], dtype=dtype)
        nan.view(bits)[0] |= 0x5                   # a NaN payload
        vals[1] = nan[0]
        vals[2] = np.inf
    idx_p, vals_p, bucket = resident._pad_updates(idx, vals)
    assert bucket > idx.size                       # padded: duplicates
    coords = np.ascontiguousarray(np.stack(np.unravel_index(
        idx_p.astype(np.int64), shape)).astype(np.int32))
    rmesh = ref_mesh.make_mesh(8, eval_parallel=e_par)
    pspec = PartitionSpec(*spec)
    with rmesh:
        buf = jax.device_put(base, NamedSharding(rmesh, pspec))
        rep = NamedSharding(rmesh, PartitionSpec())
        want = ref_mesh.mesh_delta_scatter_fn(
            rmesh, shape, base.dtype.str, int(idx_p.size), pspec)(
                buf, jax.device_put(coords, rep),
                jax.device_put(vals_p, rep))
    grid = mesh.make_mesh(CELLS, eval_parallel=e_par)
    sh = mesh.put_by_spec(base, spec, grid)
    got = mesh.mesh_delta_scatter_plain(sh, coords, vals_p)
    assert _bytes_equal(got.cpu().numpy(), np.asarray(want))
    wrapped = mesh.mesh_delta_scatter(sh, coords, vals_p)
    assert _bytes_equal(wrapped.cpu().numpy(), np.asarray(want))
    # the base is never written
    assert _bytes_equal(sh.cpu().numpy(), base)


SCATTER_GRIDS = [(1, 4), (2, 2), (4, 1), (8, 1)]
SCATTER_SPECS = {"sharded": mesh.EN, "evals_only": ("evals", None),
                 "replicated": (None, None)}


def _edge_updates(rng, shape, e_par, n_par, k):
    """k flat indices of a (rows, cols) table: the first and last row and
    column of every cell's slice on a (e_par, n_par) grid, then random
    ones; distinct."""
    rows, cols = shape
    rs = sorted({x for p in range(e_par) for x in (
        p * rows // e_par, (p + 1) * rows // e_par - 1)})
    cs = sorted({x for p in range(n_par) for x in (
        p * cols // n_par, (p + 1) * cols // n_par - 1)})
    edge = [r * cols + c for r in rs for c in cs]
    rest = [int(x) for x in rng.permutation(rows * cols) if x not in edge]
    return np.asarray((edge + rest)[:k], dtype=np.int64)


@pytest.mark.parametrize("k", [0, 12, 45])
@pytest.mark.parametrize("spec_name", sorted(SCATTER_SPECS))
@pytest.mark.parametrize("e_par,n_par", SCATTER_GRIDS)
def test_grouped_coord_scatter_matches_reference(e_par, n_par, spec_name,
                                                 k, monkeypatch):
    """mesh_delta_scatter groups a grid's cells by device: one payload
    upload and one coord_scatter_cells call per device (all the cells
    here are the CPU), and coord_scatter_cells_plain applies
    coord_scatter_plain cell by cell; both equal the reference's
    mesh_delta_scatter_fn on the virtual XLA devices byte for byte, with
    updates on every cell's edges, padded duplicates and k = 0."""
    _needs_8_devices()
    from jax.sharding import NamedSharding, PartitionSpec
    n_cells = e_par * n_par
    spec = SCATTER_SPECS[spec_name]
    rng = np.random.default_rng(100 + 10 * n_cells + k)
    shape = (8, 64)
    base = (rng.standard_normal(shape) * 50).astype(np.float32)
    idx = _edge_updates(rng, shape, e_par, n_par, k)
    vals = base.reshape(-1)[idx] + np.float32(1)
    if k:
        idx_p, vals_p, bucket = resident._pad_updates(idx, vals)
        assert bucket > idx.size                   # padded: duplicates
    else:
        idx_p, vals_p = idx.astype(np.int32), vals
    coords = np.ascontiguousarray(np.stack(np.unravel_index(
        idx_p.astype(np.int64), shape)).astype(np.int32)).reshape(2, -1)
    rmesh = ref_mesh.make_mesh(n_cells, eval_parallel=e_par)
    pspec = PartitionSpec(*spec)
    with rmesh:
        buf = jax.device_put(base, NamedSharding(rmesh, pspec))
        rep = NamedSharding(rmesh, PartitionSpec())
        want = np.asarray(ref_mesh.mesh_delta_scatter_fn(
            rmesh, shape, base.dtype.str, int(idx_p.size), pspec)(
                buf, jax.device_put(coords, rep),
                jax.device_put(vals_p, rep)))
    grid = mesh.make_mesh(["cpu"] * n_cells, eval_parallel=e_par)
    sh = mesh.put_by_spec(base, spec, grid)
    uploads, calls = [], []
    put, cells = resident.put_coord_payload, resident.coord_scatter_cells

    def counted_put(c, v, dev):
        uploads.append(dev)
        return put(c, v, dev)

    def counted_cells(parts, payload, starts):
        calls.append(len(parts))
        return cells(parts, payload, starts)

    monkeypatch.setattr(resident, "put_coord_payload", counted_put)
    monkeypatch.setattr(resident, "coord_scatter_cells", counted_cells)
    got = mesh.mesh_delta_scatter(sh, coords, vals_p)
    assert uploads == [torch.device("cpu")] and calls == [n_cells]
    assert _bytes_equal(got.cpu().numpy(), want)
    for part, start in zip(got.parts, (
            [s.start or 0 for s in ix]
            for _k, _d, ix in mesh.cuts(shape, spec, grid))):
        rows = tuple(slice(a, a + n) for a, n in zip(start, part.shape))
        assert _bytes_equal(part.numpy(), want[rows])
    plain = mesh.mesh_delta_scatter_plain(sh, coords, vals_p)
    assert _bytes_equal(plain.cpu().numpy(), want)
    assert len(uploads) == 2 and calls == [n_cells]
    assert _bytes_equal(sh.cpu().numpy(), base)    # the base never written


def test_coord_scatter_cells_uploads_once_per_device(monkeypatch):
    """Cells on two devices (torch's "cpu" and "cpu:0" name two devices
    whose tensors both live in host memory) get one payload upload and
    one call each; coord_scatter_cells_plain equals coord_scatter_plain
    on each cell, and the wrapper checks its arguments."""
    rng = np.random.default_rng(7)
    shape = (8, 32)
    base = rng.standard_normal(shape).astype(np.float32)
    grid = mesh.Grid(["cpu", "cpu", "cpu:0", "cpu:0"], 2, 2)
    sh = mesh.put_by_spec(base, mesh.EN, grid)
    idx = _edge_updates(rng, shape, 2, 2, 20)
    idx_p, vals_p, _ = resident._pad_updates(
        idx, base.reshape(-1)[idx] - np.float32(3))
    coords = np.ascontiguousarray(np.stack(np.unravel_index(
        idx_p.astype(np.int64), shape)).astype(np.int32))
    uploads = []
    put = resident.put_coord_payload
    monkeypatch.setattr(resident, "put_coord_payload",
                        lambda c, v, d: uploads.append(str(d)) or put(c, v,
                                                                   d))
    got = mesh.mesh_delta_scatter(sh, coords, vals_p)
    assert sorted(uploads) == ["cpu", "cpu:0"]
    full = base.copy()
    full.reshape(-1)[idx_p] = vals_p
    assert _bytes_equal(got.cpu().numpy(), full)
    parts = [torch.from_numpy(base[:4, :16].copy()),
             torch.from_numpy(base[4:, 16:].copy())]
    payload = put(coords, vals_p, torch.device("cpu"))
    cells = resident.coord_scatter_cells_plain(parts, payload,
                                               [[0, 0], [4, 16]])
    for part, st, out in zip(parts, ([0, 0], [4, 16]), cells):
        assert torch.equal(out, resident.coord_scatter_plain(
            part, payload[0], payload[1], st))
    with pytest.raises(ValueError):
        resident.coord_scatter_cells([parts[0], parts[1][:2]], payload,
                                     [[0, 0], [4, 16]])
    with pytest.raises(ValueError):
        resident.coord_scatter_cells(parts, payload, [[0, 0]])


def test_coord_scatter_drops_other_cells_updates():
    part = torch.zeros((2, 4), dtype=torch.float32)
    coords = torch.tensor([[0, 1, 3], [5, 6, 1]], dtype=torch.int32)
    vals = torch.tensor([1.0, 2.0, 3.0])
    (out,) = resident.coord_scatter_cells([part], (coords, vals), [[0, 4]])
    assert out[0, 1] == 1.0 and out[1, 2] == 2.0
    assert float(out.sum()) == 3.0 and float(part.sum()) == 0.0
    with pytest.raises(TypeError):
        resident.coord_scatter_cells([part], (coords.long(), vals), [[0, 4]])
    with pytest.raises(ValueError):
        resident.coord_scatter_cells([part], (coords, vals), [[0]])


def _uniform_lanes(k, count=6, lo=0):
    from nomad_tpu_torch.solver.service import pack_lane_arrays
    from nomad_tpu_torch.tensor.pack import NodeMatrix, UsageState
    n, n_pad = 20, 64
    matrix = NodeMatrix(
        n_real=n, n_pad=n_pad, node_ids=[f"n{i}" for i in range(n)],
        cpu_cap=np.r_[np.full(n, 4000.0), np.zeros(n_pad - n)],
        mem_cap=np.r_[np.full(n, 8192.0), np.zeros(n_pad - n)],
        disk_cap=np.r_[np.full(n, 102400.0), np.zeros(n_pad - n)],
        dyn_free=np.full(n_pad, 100, dtype=np.int32),
        valid=np.arange(n_pad) < n)
    rng = np.random.default_rng(lo)
    z = np.zeros(n_pad)
    zi = np.zeros(n_pad, dtype=np.int32)
    used = np.r_[rng.uniform(0, 3000, n), np.zeros(n_pad - n)]
    usage = UsageState(used, z, z, zi, zi, zi)
    return [pack_lane_arrays(matrix, usage, np.ones(n_pad, dtype=bool),
                             ask=(500.0, 256.0, 150.0), count=count,
                             n_places=count, eval_id=f"mesh-{lo + i:04d}",
                             state_index=1, device="cpu")
            for i in range(k)]


@pytest.mark.parametrize("n_cells", [2, 4, 8])
def test_eval_sharded_wave_equals_unsharded(n_cells):
    lanes = _uniform_lanes(8, lo=n_cells)
    assert all(ln.wavefront_ok() for ln in lanes)
    one = batch.fuse_and_solve(lanes, device="cpu")
    got = batch.fuse_and_solve(lanes, device=["cpu"] * n_cells)
    assert mesh.mesh_stats()["eval_sharded_dispatches"] == 1
    for a, b in zip(got, one):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    # cells that do not divide the eval axis: the first cell runs it all
    batch.fuse_and_solve(lanes[:5], device=["cpu"] * 3)
    assert mesh.mesh_stats()["eval_sharded_dispatches"] == 1


def test_eval_sharded_wave_preempt_equals_unsharded():
    from nomad_tpu_torch.solver import preempt, wave
    rng = np.random.default_rng(4)
    names = ("NodeConst", "NodeState", "PlacementBatch", "PreemptTables",
             "PreemptState")
    lanes = []
    for _ in range(4):
        dicts = chip_smoke.preempt_fuzz_tables(
            np, rng, n=24, n_pad=32, p=8, dtype="float64", limit=4)
        lanes.append([getattr(port_bp, nm)(**{f: d[f] for f in
                                              getattr(port_bp, nm)._fields
                                              if f in d})
                      for nm, d in zip(names, dicts)])
    trees = [_stack([ln[k] for ln in lanes]) for k in range(5)]
    kw = dict(spread_alg=False, dtype_name="float64")
    one = preempt.solve_lane_wave_preempt(*trees, device="cpu", **kw)
    got = wave.solve_lane_fused(*trees, wave=True, device=["cpu"] * 4,
                                **kw)
    assert mesh.mesh_stats()["eval_sharded_dispatches"] == 1
    for x, y in zip(got, one):
        np.testing.assert_array_equal(x, y)
    assert (one[0] >= 0).any()


def test_pick_mesh_matches_reference(monkeypatch):
    _needs_8_devices()
    for d in range(1, 9):
        for e in (1, 2, 3, 4, 5, 6, 8, 12, 16, 32, 33):
            for n in (1, 7, 64, 96, 256, 1000, 1024):
                want = ref_mesh.pick_mesh(e, n, n_devices=d)
                got = mesh.pick_mesh(e, n, ["cpu"] * d)
                if want is None:
                    assert got is None, (d, e, n)
                else:
                    assert got.shape == want.devices.shape, (d, e, n)
        assert mesh.make_mesh(["cpu"] * d).shape == \
            ref_mesh.make_mesh(d).devices.shape
    monkeypatch.setenv("NOMAD_TPU_TORCH_MESH", "0")
    assert not mesh.mesh_enabled()
    assert mesh.pick_mesh(8, 256, CELLS) is None
    monkeypatch.delenv("NOMAD_TPU_TORCH_MESH")
    assert mesh.mesh_enabled()
    assert mesh.pick_mesh(8, 256, ["cpu"]) is None


def test_kill_switch_runs_one_device_bit_for_bit(monkeypatch):
    lanes = _uniform_lanes(8, lo=40)
    on = batch.fuse_and_solve(lanes, device=CELLS)
    monkeypatch.setenv("NOMAD_TPU_TORCH_MESH", "0")
    mesh._reset_for_tests()
    off = batch.fuse_and_solve(lanes, device=CELLS)
    assert mesh.mesh_stats()["eval_sharded_dispatches"] == 0
    for a, b in zip(on, off):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


# ----------------------------------------------------------------------
# four generations through both packages' fuse_and_solve, mesh on

N_NODES = 48


def _sched_world():
    """A reference world: 48 nodes half filled by a priority-20 job, 8
    plain lanes (a wave group of 8: eval-sharded over 8 devices) and 4
    spread lanes at count 140 (a dense group: a (4, 2) grid)."""
    from nomad_tpu.scheduler import Harness
    from nomad_tpu.scheduler.context import EvalContext
    from nomad_tpu.scheduler.reconcile import AllocPlaceResult
    from nomad_tpu.solver.service import TpuPlacementService
    from nomad_tpu.structs import Plan, Spread

    h = Harness()
    nodes = []
    for i in range(N_NODES):
        n = mock.node()
        n.id = f"mesh-node-{i:04d}"
        n.node_resources.cpu.cpu_shares = (2000, 4000, 8000)[i % 3]
        n.node_resources.memory.memory_mb = (4096, 8192, 16384)[i % 3]
        n.meta["rack"] = f"r{i % 5}"
        n.compute_class()
        nodes.append(n)
        h.state.upsert_node(n)
    filler = mock.job(id="mesh-filler")
    filler.priority = 20
    h.state.upsert_job(filler)
    h.state.upsert_allocs([mock.alloc_for(filler, nodes[k], index=k)
                           for k in range(0, N_NODES, 2)])
    snap = h.state.snapshot()
    specs = [("plain", 10 + i) for i in range(8)] + [("spread", 140)] * 4
    lanes = []
    for i, (kind, count) in enumerate(specs):
        job = mock.job(id=f"mesh-job-{i}")
        tg = job.task_groups[0]
        tg.count = count
        if kind == "spread":
            tg.tasks[0].resources.cpu = 100
            tg.tasks[0].resources.memory_mb = 64
            tg.spreads = [Spread(attribute="${meta.rack}", weight=50)]
        h.state.upsert_job(job)
        plan = Plan(eval_id=f"mesh-eval-{i:027d}", priority=50, job=job)
        ctx = EvalContext(snap, plan)
        places = [AllocPlaceResult(name=f"{job.id}.{tg.name}[{k}]",
                                   task_group=tg) for k in range(count)]
        svc = TpuPlacementService(ctx, job, batch_mode=False,
                                  spread_alg=False)
        lane = svc.pack(tg, places, nodes)
        assert lane is not None and lane.delta_src is not None
        lanes.append(lane)
    assert [ln.wavefront_ok() for ln in lanes] == [True] * 8 + [False] * 4
    return h, nodes, filler, lanes


STAT_KEYS = ("hits", "misses", "bytes_shipped_total", "bytes_saved_total",
             "delta_promotions", "delta_reuses", "delta_fallbacks",
             "delta_gap_fallbacks", "delta_size_fallbacks",
             "delta_bytes_total", "resident_bytes", "chain_resident_bytes",
             "entries", "chain_entries", "shard_resident_bytes",
             "shard_resident_hwm", "shard_entries", "evictions")


def test_sharded_generations_match_reference(monkeypatch):
    _needs_8_devices()
    from nomad_tpu_torch.carry import lane_from_reference
    monkeypatch.setenv("NOMAD_TPU_MESH", "1")
    # the world's per-cell slices are small: admit them to the pools
    monkeypatch.setenv("NOMAD_TPU_CONST_CACHE_MIN_BYTES", "256")
    monkeypatch.setenv("NOMAD_TPU_TORCH_CONST_CACHE_MIN_BYTES", "256")
    ref_batch.arena_clear("test")
    batch.arena_clear("test")
    h, nodes, filler, lanes = _sched_world()
    lanes = [copy.copy(ln) for ln in lanes]
    for ln in lanes:
        ln.init = type(ln.init)(*(np.array(a) for a in ln.init))
    store = h.state
    seen = []

    def carry():
        return [lane_from_reference(
            ln.const, ln.init, ln.batch, ln.order, dtype_name=ln.dtype_name,
            spread_alg=ln.spread_alg, node_ids=ln.matrix.node_ids,
            table_version=ln.table_version, delta_src=ln.delta_src,
            device="cpu") for ln in lanes]

    def generation():
        want = ref_batch.fuse_and_solve(lanes, use_mesh=True)
        got = batch.fuse_and_solve(carry(), device=CELLS)
        for w, g in zip(want, got):
            for x, y in zip(w, g):
                np.testing.assert_array_equal(y, x)
        st_w, st_g = constcache.stats(), resident.stats()
        for k in STAT_KEYS:
            assert st_g[k] == st_w[k], (k, st_g[k], st_w[k], len(seen))
        for buf, shadow in resident.chain_entries():
            assert _bytes_equal(buf.cpu().numpy(), shadow)
        seen.append(dict(st_g))

    generation()                                   # g1: cold
    ms = mesh.mesh_stats()
    assert ms["dense_dispatches"] == 1 and ms["node_sharded_steps"] > 0
    assert ms["eval_sharded_dispatches"] == 1
    assert seen[0]["shard_entries"] > 0 and seen[0]["chain_entries"] > 0
    store.upsert_allocs([mock.alloc_for(filler, nodes[1], index=900)])
    for ln in lanes:
        ln.delta_src = (store, store.latest_index())
    generation()                                   # g2: hits, reuses
    assert seen[1]["delta_reuses"] > 0 and seen[1]["hits"] > 0
    store.upsert_allocs([mock.alloc_for(filler, nodes[k], index=910 + k)
                         for k in (3, 5)])
    for ln in lanes:
        ln.delta_src = (store, store.latest_index())
    for f, a in zip(("used_cpu", "used_mem", "used_disk"),
                    (100.0, 64.0, 150.0)):
        getattr(lanes[8].init, f)[[3, 5]] += a
    generation()                                   # g3: the grid's scatter
    assert seen[2]["delta_promotions"] > 0
    with store._lock:
        store._bump("allocs")
    for ln in lanes:
        ln.delta_src = (store, store.latest_index())
    getattr(lanes[8].init, "used_cpu")[[7]] += 100.0
    generation()                                   # g4: gap
    assert seen[3]["delta_gap_fallbacks"] > 0
