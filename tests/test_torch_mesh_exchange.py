"""A model of the persistent mesh kernels' exchange protocol
(nomad_tpu_torch/csrc/mesh_exchange.cuh) on the CPU.

On the card the node-sharded scan (csrc/dense_shard.cu) and the
lane-sharded LP (csrc/lp_relax.cu nt_lp_shard_f32) run every step of
every cell in one launch per card, and the cells meet only through
flagged slots. Here each unit of those kernels is a generator over the
plain phase functions of solver/dense.py and solver/lpq.py that yields
at every store, publish and poll; the slots and sequence words are
numpy arrays laid out, and double-buffered by parity, as the header
says (its constants and its layout comment are read with a regex).
Seeded schedules interleave the units with skewed speeds:

  * scan units are (cell, lane) pairs (a single-lane ShardCell each):
    count, store the (fit, low) pair, publish; poll the cells before it
    and, unless those and its own already count ``limit`` nodes, the
    cells after it; select, store the record, publish; poll every peer,
    reading each slot right after its poll, as the kernel's polling
    lanes do; commit;
  * LP units are cells: rows, store every own lane's (max, sum),
    publish; poll the column's cells, then read every lane's
    statistics, as the kernel's blocks do; nodes; the final pass.

On every grid of GRID, each schedule's outputs equal, bit for bit, the
plain route (mesh.run_node_sharded / run_lpq_cells, through mesh_solve
and mesh_lpq on CPU cells), the one-device solve (solve_placements /
the reference's _lp_program) and the reference's mesh_solve_fn /
mesh_lpq_fn on conftest's 8 virtual XLA devices. Two mutants must be
caught by some schedule of the search: slots without the parity copy,
and a publish before the slot's last store. The plain step loops refuse
a group with a missing cell, as the kernel's bounded wait does.
"""
import functools
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
import chip_smoke
from nomad_tpu.parallel import mesh as ref_mesh
from nomad_tpu.solver import binpack as ref_bp

from nomad_tpu_torch.parallel import mesh
from nomad_tpu_torch.solver import binpack as port_bp
from nomad_tpu_torch.solver import dense, exchange, lpq
from nomad_tpu_torch.solver.scoring import MAX_SKIP

torch.set_num_threads(1)

HDR = (Path(__file__).resolve().parents[1] / "nomad_tpu_torch" / "csrc"
       / "mesh_exchange.cuh").read_text()


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", HDR).group(1))


PARITIES = _const("kParities")
SHARD_POINTS = _const("kShardPoints")
LP_POINTS = _const("kLpPoints")
CNT_WORDS = _const("kCntWords")
STAT_ROWS = _const("kStatRows")
ERR_WORDS = _const("kErrWords")

GRID = [(8, 1), (4, 2), (2, 4), (1, 8)]
CELLS = ["cpu"] * 8
SCHEDULES = 2          # seeded interleavings per grid, dtype and world
SEARCH = 150           # schedules a mutant search may take


def _layout(group):
    """[(name, [dims])] of an area layout from the header's comment."""
    block = re.search(rf"//\s+{group} group \([^)]*\):\n((?://\s{{5}}.*\n)+)",
                      HDR).group(1)
    text = " ".join(line.strip("/ \n") for line in block.splitlines())
    return [(m.group(1), re.findall(r"\[(\w+)\]", m.group(2)))
            for m in re.finditer(r"(\w+) ((?:\[\w+\])+)", text)]


def _np_views(area, layout, env, dtypes=None):
    """numpy views of ``area`` (int32) in the layout's order."""
    out, off = {}, 0
    for name, dims in layout:
        shape = tuple(env[d] for d in dims)
        n = int(np.prod(shape))
        v = area[off:off + n]
        if dtypes and name in dtypes:
            v = v.view(dtypes[name])
        out[name] = v.reshape(shape)
        off += n
    assert off == area.shape[0]
    return out


def _scan_env(n_par, E, W):
    return {"kParities": PARITIES, "n_par": n_par, "E": E,
            "kCntWords": CNT_WORDS, "W": W}


def _lp_env(G, L):
    return {"kParities": PARITIES, "kStatRows": STAT_ROWS, "L": L, "G": G}


def test_header_constants_match_the_host_half():
    assert (PARITIES, SHARD_POINTS, LP_POINTS, CNT_WORDS, STAT_ROWS,
            ERR_WORDS) == (exchange.PARITIES, exchange.SHARD_POINTS,
                           exchange.LP_POINTS, exchange.CNT_WORDS,
                           exchange.STAT_ROWS, exchange.ERR_WORDS)
    assert PARITIES == 2 and SHARD_POINTS == 2 and LP_POINTS == 1
    assert [n for n, _ in _layout("scan")] == ["cnt", "rec", "seq"]
    assert [n for n, _ in _layout("LP")] == ["stats", "seq"]


@pytest.mark.parametrize("n_par,E,W", [(2, 1, 4), (4, 3, 7), (8, 8, 9)])
def test_host_views_follow_the_header_layout(n_par, E, W):
    """exchange.shard_views / lp_views cut the area where the header's
    layout puts each table."""
    words = exchange.shard_area_words(n_par, E, W)
    area = torch.arange(words, dtype=torch.int32)
    want = _np_views(area.numpy(), _layout("scan"), _scan_env(n_par, E, W))
    for name, got in zip(("cnt", "rec", "seq"),
                         exchange.shard_views(area, n_par, E, W)):
        np.testing.assert_array_equal(got.numpy(), want[name])
    G, L = n_par, 8 * E
    area = torch.arange(exchange.lp_area_words(G, L), dtype=torch.int32)
    want = _np_views(area.numpy(), _layout("LP"), _lp_env(G, L))
    stats, seq = exchange.lp_views(area, G, L)
    np.testing.assert_array_equal(stats.view(torch.int32).numpy(),
                                  want["stats"])
    np.testing.assert_array_equal(seq.numpy(), want["seq"])


# --------------------------------------------------------------------------
# The scheduler.

class Deadlock(AssertionError):
    pass


def _run(programs, rng):
    """Run generator ``programs`` to their ends in a seeded interleaving:
    a program yields None (a scheduling point) or a predicate (a poll: it
    resumes only once the predicate holds). Each program gets a skewed
    speed, its weight whenever it is runnable."""
    speeds = rng.uniform(0.02, 1.0, len(programs)) ** 3
    pending = [None] * len(programs)
    live = list(range(len(programs)))
    while live:
        ready = [k for k in live if pending[k] is None or pending[k]()]
        if not ready:
            raise Deadlock("no unit can move")
        w = speeds[ready]
        k = ready[rng.choice(len(ready), p=w / w.sum())]
        try:
            pending[k] = next(programs[k])
        except StopIteration:
            live.remove(k)


def _seen(seq, at, target):
    return lambda: seq[at] >= target


def _publish(slot, words, seq, at, value, early):
    """Store ``words`` into ``slot`` one at a time, then publish ``value``
    into seq[at]; ``early`` (a mutant) publishes before the last store."""
    for k, w in enumerate(words):
        if early and k == len(words) - 1:
            seq[at] = value
            yield None
        slot[k] = w
        yield None
    if not early:
        seq[at] = value
        yield None


# --------------------------------------------------------------------------
# The scan model.

def _scan_world(dtype_name, seed, *, kind="fuzz", E=8, n_pad=128, p=8):
    """E stacked reference lanes over n_pad nodes, p steps: the varied
    world (every step yields ``limit`` options: the cells after a prefix
    that counts them are not waited for) or the fuzz world (spreads,
    distinct_property, devices, reserved cores, ports and penalties:
    value indices cross cells)."""
    rng = np.random.default_rng(seed)
    lanes = []
    for _ in range(E):
        if kind == "varied":
            ln = graft._varied_inputs(rng, n_pad, p, dtype=dtype_name)
            lanes.append(tuple(type(t)(*(np.asarray(a) for a in t))
                               for t in ln))
            continue
        c, s, b = chip_smoke.dense_fuzz_tables(
            np, rng, n=n_pad - 8, n_pad=n_pad, p=p, dtype=dtype_name,
            limit=6, features=chip_smoke.DENSE_FEATURES[1:])
        lanes.append((ref_bp.NodeConst(**c), ref_bp.NodeState(**s),
                      ref_bp.PlacementBatch(**b)))
    return [type(lanes[0][k])(*(np.stack([np.asarray(getattr(ln[k], f))
                                          for ln in lanes])
                                for f in lanes[0][k]._fields))
            for k in range(3)]


def _port(tree):
    cls = {"NodeConst": port_bp.NodeConst, "NodeState": port_bp.NodeState,
           "PlacementBatch": port_bp.PlacementBatch}[type(tree).__name__]
    return cls(*(np.asarray(getattr(tree, f)) for f in cls._fields))


def _lane(tree, e):
    return type(tree)(*(x[e:e + 1] for x in tree))


def _scan_unit(c, sh, e, *, single, early, stats):
    """One (cell, lane) unit of csrc/dense_shard.cu: c a single-lane
    ShardCell with a private area, sh its row's shared numpy slots."""
    j, n_par = c.j, c.n_par
    for i in range(c.chosen.shape[1]):
        pp = i % PARITIES
        ps = 0 if single else pp
        # 1-2. count, publish, the prefix (and, unless it suffices, the rest)
        dense._shard_count_plain(c, i)
        tgt = i * SHARD_POINTS + 1
        yield from _publish(sh["cnt"][ps, j, e], c.cnt[pp, j, 0].numpy().copy(),
                            sh["seq"], (j, e), tgt, early)
        for q in range(j):
            yield _seen(sh["seq"], (q, e), tgt)
            c.cnt[pp, q, 0] = torch.from_numpy(sh["cnt"][ps, q, e].copy())
        fit, low = c.cnt[pp, :j + 1, 0].long().sum(dim=0).tolist()
        if fit - min(low, MAX_SKIP) < int(c.batch.limit[0, i]):
            for q in range(j + 1, n_par):
                yield _seen(sh["seq"], (q, e), tgt)
                c.cnt[pp, q, 0] = torch.from_numpy(sh["cnt"][ps, q, e].copy())
        else:
            stats["prefix_only"] += 1
            c.cnt[pp, j + 1:, 0] = 0
        # 3-4. select, publish the record, read every peer's
        dense._shard_select_plain(c, i)
        tgt = i * SHARD_POINTS + 2
        yield from _publish(sh["rec"][ps, j, e], c.rec[pp, j, 0].numpy().copy(),
                            sh["seq"], (j, e), tgt, early)
        for q in range(n_par):
            if q != j:
                yield _seen(sh["seq"], (q, e), tgt)
                c.rec[pp, q, 0] = torch.from_numpy(sh["rec"][ps, q, e].copy())
        # 5. commit
        dense._shard_commit_plain(c, i)


def _scan_model(grid, trees, dtype_name, rng, *, single=False, early=False,
                stats=None, with_state=False):
    """The scan's outputs (chosen, scores, n_yielded) under one schedule;
    every cell of a row must reach the same outputs. ``with_state`` adds
    every unit's final state, in unit order."""
    stats = stats if stats is not None else {"prefix_only": 0}
    s = mesh.shard_solver_inputs(grid, *trees)
    cast = dense.lane_casts(dtype_name)
    units, programs = {}, []
    for i in range(grid.e_par):
        cell_trees = [[mesh._cell_tree(t, i, j, cast)
                       for t in (s.const, s.init, s.batch)]
                      for j in range(grid.n_par)]
        Ec = cell_trees[0][0].cpu_cap.shape[0]
        W = None
        for e in range(Ec):
            for j in range(grid.n_par):
                c = dense.ShardCell(*(_lane(t, e) for t in cell_trees[j]),
                                    j=j, n_par=grid.n_par, spread_alg=False)
                units[(i, j, e)] = c
                W = c.words
        area = np.zeros(exchange.shard_area_words(grid.n_par, Ec, W),
                        dtype=np.int32)
        sh = _np_views(area, _layout("scan"), _scan_env(grid.n_par, Ec, W))
        for e in range(Ec):
            for j in range(grid.n_par):
                programs.append(_scan_unit(units[(i, j, e)], sh, e,
                                           single=single, early=early,
                                           stats=stats))
    _run(programs, rng)
    out = []
    for f in ("chosen", "scores", "n_yielded"):
        rows = []
        for i in range(grid.e_par):
            Ec = sum(1 for (a, b, _) in units if a == i and b == 0)
            lanes = [getattr(units[(i, 0, e)], f) for e in range(Ec)]
            for j in range(1, grid.n_par):
                for e in range(Ec):
                    if not torch.equal(getattr(units[(i, j, e)], f),
                                       lanes[e]):
                        raise AssertionError(f"cells of row {i} disagree")
            rows.append(torch.cat(lanes).numpy())
        out.append(np.concatenate(rows))
    if with_state:
        out += [getattr(units[k].state, f).numpy()
                for k in sorted(units) for f in port_bp.NodeState._fields]
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _scan_expected(e_par, dtype_name, seed, kind):
    const, init, batch_t = _scan_world(dtype_name, seed, kind=kind)
    ports = [_port(t) for t in (const, init, batch_t)]
    rmesh = ref_mesh.make_mesh(8, eval_parallel=e_par)
    with rmesh:
        s_c, s_i, s_b = ref_mesh.shard_solver_inputs(rmesh, const, init,
                                                     batch_t)
        ref_out = ref_mesh.mesh_solve_fn(rmesh, False, dtype_name)(
            s_c, s_i, s_b)
    grid = mesh.make_mesh(CELLS, eval_parallel=e_par)
    plain = mesh.mesh_solve(grid, *ports, spread_alg=False,
                            dtype_name=dtype_name)
    one = dense.solve_placements(*ports, spread_alg=False,
                                 dtype_name=dtype_name, device="cpu")
    return ports, (tuple(np.asarray(x) for x in ref_out[:3]), plain,
                   tuple(x.numpy() for x in one[:3]))


def _same(a, b):
    return all(np.asarray(x).dtype == np.asarray(y).dtype and
               np.asarray(x).shape == np.asarray(y).shape and
               np.asarray(x).tobytes() == np.asarray(y).tobytes()
               for x, y in zip(a, b))


@pytest.mark.parametrize("world", ["varied", "fuzz"])
@pytest.mark.parametrize("dtype_name", ["float32", "float64"])
@pytest.mark.parametrize("e_par,n_par", GRID)
def test_scan_model_matches_routes_and_reference(e_par, n_par, dtype_name,
                                                 world):
    if jax.device_count() < 8:
        pytest.skip("needs the 8 virtual XLA devices of tests/conftest.py")
    seed = 300 + e_par
    ports, (ref_out, plain, one) = _scan_expected(e_par, dtype_name, seed,
                                                  world)
    assert _same(ref_out, one) and _same(plain, one)
    assert (one[0] >= 0).any()
    grid = mesh.make_mesh(CELLS, eval_parallel=e_par)
    stats = {"prefix_only": 0}
    for k in range(SCHEDULES):
        got = _scan_model(grid, ports, dtype_name,
                          np.random.default_rng(1000 * e_par + k),
                          stats=stats)
        assert _same(got, one), f"schedule {k}"
    if n_par > 1 and world == "varied":
        # the cells after a prefix that counts `limit` were not waited for
        assert stats["prefix_only"] > 0


# --------------------------------------------------------------------------
# The LP model.

def _lp_world(seed, L=16, N=256):
    rng = np.random.default_rng(seed)
    V = rng.standard_normal((L, N)).astype(np.float32)
    feas = rng.uniform(size=(L, N)) > 0.3
    ask = np.abs(rng.standard_normal((L, 3))).astype(np.float32)
    pcount = rng.integers(1, 4, L).astype(np.float32)
    free = (np.abs(rng.standard_normal((N, 3))) * 4.0).astype(np.float32)
    active = np.ones(L, dtype=bool)
    active[-1] = False
    return V, feas, ask, pcount, free, active


def _lp_unit(c, sh, *, single, early):
    """One cell of nt_lp_shard_f32: c an LpShardCell with a private area,
    sh its column's shared numpy slots."""
    lpq._lp_shard_plain(c, lpq.LP_INIT, 0)
    yield None
    lanes = range(c.l0, c.l1)
    for t in range(int(c.temps.shape[0])):
        pp = c.parity(t)
        ps = 0 if single else pp
        lpq._lp_shard_plain(c, lpq.LP_ROWS, t)
        slot = sh["stats"][ps].reshape(-1)          # (max row, sum row)
        L = c.V.shape[0]
        idx = [r * L + l for l in lanes for r in range(STAT_ROWS)]
        vals = [float(c.rmax[pp, l]) if r == 0 else float(c.rsum[pp, l])
                for l in lanes for r in range(STAT_ROWS)]
        tgt = t * LP_POINTS + 1
        view = _Indexed(slot, idx)
        yield from _publish(view, np.asarray(vals, dtype=np.float32),
                            sh["seq"], c.gi, tgt, early)
        for q in range(c.G):
            if q != c.gi:
                yield _seen(sh["seq"], q, tgt)
        # every lane's statistics, read once every peer has published
        c.rmax[pp] = torch.from_numpy(sh["stats"][ps, 0].copy())
        c.rsum[pp] = torch.from_numpy(sh["stats"][ps, 1].copy())
        lpq._lp_shard_plain(c, lpq.LP_NODES, t)
    pp = c.parity(-1)
    ps = 0 if single else pp
    lpq._lp_shard_plain(c, lpq.LP_ROWS, -1)
    for l in lanes:
        sh["stats"][ps, 0, l] = float(c.rmax[pp, l])
        sh["stats"][ps, 1, l] = float(c.rsum[pp, l])
        yield None
    lpq._lp_shard_plain(c, lpq.LP_WRITE_X, -1)


class _Indexed:
    """Stores into ``base`` at the listed flat indexes."""

    def __init__(self, base, idx):
        self.base, self.idx = base, idx

    def __setitem__(self, k, v):
        self.base[self.idx[k]] = v


def _lp_model(grid, arrays, steps, rng, *, single=False, early=False):
    s_in, _ = mesh.shard_lpq_inputs(grid, *arrays)
    rows = mesh.lpq_cells(grid, s_in, lpq.lp_temperatures(steps))
    L = arrays[0].shape[0]
    programs = []
    for j in range(grid.n_par):
        area = np.zeros(exchange.lp_area_words(grid.e_par, L),
                        dtype=np.int32)
        sh = _np_views(area, _layout("LP"), _lp_env(grid.e_par, L),
                       {"stats": np.float32})
        for i in range(grid.e_par):
            c = rows[i][j]
            c.bind_area(exchange.zeros(exchange.lp_area_words(c.G, L),
                                       torch.device("cpu"), False))
            programs.append(_lp_unit(c, sh, single=single, early=early))
    _run(programs, rng)
    mu = rows[0][0].mu
    for row in rows:
        for c in row:
            if not torch.equal(c.mu, mu) or not torch.equal(c.X, row[0].X):
                raise AssertionError("cells disagree")
    return torch.cat([row[0].X for row in rows]).numpy(), mu.numpy()


@functools.lru_cache(maxsize=None)
def _lp_expected(e_par, seed, steps):
    from nomad_tpu.solver.lpq import _lp_program
    arrays = _lp_world(seed)
    L, N = arrays[0].shape
    X_ref, mu_ref = _lp_program(L, N, steps)(*arrays)
    rmesh = ref_mesh.make_mesh(8, eval_parallel=e_par)
    with rmesh:
        s_in = ref_mesh.shard_lpq_inputs(rmesh, *arrays)
        X_m, mu_m = ref_mesh.mesh_lpq_fn(rmesh, L, N, steps)(*s_in)
    grid = mesh.make_mesh(CELLS, eval_parallel=e_par)
    p_in, _ = mesh.shard_lpq_inputs(grid, *arrays)
    X_p, mu_p = mesh.mesh_lpq(grid, p_in, lpq.lp_temperatures(steps))
    return arrays, ((np.asarray(X_ref), np.asarray(mu_ref)),
                    (np.asarray(X_m), np.asarray(mu_m)),
                    (X_p.numpy(), mu_p.numpy()))


@pytest.mark.parametrize("e_par,n_par", GRID)
def test_lp_model_matches_routes_and_reference(e_par, n_par):
    if jax.device_count() < 8:
        pytest.skip("needs the 8 virtual XLA devices of tests/conftest.py")
    steps = 12
    arrays, (ref_one, ref_grid, plain) = _lp_expected(e_par, 400 + e_par,
                                                      steps)
    assert _same(ref_grid, ref_one) and _same(plain, ref_one)
    grid = mesh.make_mesh(CELLS, eval_parallel=e_par)
    for k in range(SCHEDULES):
        got = _lp_model(grid, arrays, steps,
                        np.random.default_rng(2000 * e_par + k))
        assert _same(got, ref_one), f"schedule {k}"


# --------------------------------------------------------------------------
# Teeth: the mutants are caught.

def _caught(run, want):
    for k in range(SEARCH):
        try:
            got = run(np.random.default_rng(k))
        except (AssertionError, IndexError, RuntimeError, ValueError):
            return k
        if not _same(got, want):
            return k
    return None


@functools.lru_cache(maxsize=None)
def _mutant_scan_world(kind):
    trees = [_port(t) for t in _scan_world("float32", 77, kind=kind, E=2,
                                           p=12)]
    grid = mesh.make_mesh(["cpu"] * 4, eval_parallel=1)
    want = _scan_model(grid, trees, "float32", np.random.default_rng(0),
                       with_state=True)
    return grid, trees, want


# each mutant on a world where its hazard moves a result: a single slot
# is rewritten early only by a cell whose prefix counts ``limit`` (the
# varied world); a stale last word of a record moves distinct_property
# counts (the fuzz world)
@pytest.mark.parametrize("mutant,kind", [("single", "varied"),
                                         ("early", "fuzz")])
def test_scan_mutant_is_caught(mutant, kind):
    """Every unit's outputs and final state (the counts a stale record
    would move) under the search, against an unmutated schedule's."""
    grid, trees, want = _mutant_scan_world(kind)
    # the protocol as the kernel runs it holds under the same search
    for k in range(1, 4):
        assert _same(_scan_model(grid, trees, "float32",
                                 np.random.default_rng(k),
                                 with_state=True), want)
    k = _caught(lambda rng: _scan_model(grid, trees, "float32", rng,
                                        with_state=True, **{mutant: True}),
                want)
    assert k is not None, f"no schedule caught the {mutant} mutant"


@pytest.mark.parametrize("mutant", ["single", "early"])
def test_lp_mutant_is_caught(mutant):
    steps = 8
    arrays = _lp_world(91)
    grid = mesh.make_mesh(["cpu"] * 4, eval_parallel=4)
    p_in, _ = mesh.shard_lpq_inputs(grid, *arrays)
    want = tuple(x.numpy() for x in mesh.mesh_lpq(
        grid, p_in, lpq.lp_temperatures(steps)))
    for k in range(4):
        assert _same(_lp_model(grid, arrays, steps,
                               np.random.default_rng(k)), want)
    k = _caught(lambda rng: _lp_model(grid, arrays, steps, rng,
                                      **{mutant: True}), want)
    assert k is not None, f"no schedule caught the {mutant} mutant"


# --------------------------------------------------------------------------
# A group with a missing cell: the plain step loops refuse it, as the
# kernel's bounded wait writes the error word and its caller raises.

def test_scan_group_missing_a_cell_raises():
    trees = [_port(t) for t in _scan_world("float32", 5, E=2, p=4)]
    grid = mesh.make_mesh(["cpu"] * 2, eval_parallel=1)
    s = mesh.shard_solver_inputs(grid, *trees)
    rows = mesh.shard_cells(grid, s, dense.lane_casts("float32"),
                            spread_alg=False)
    with pytest.raises(exchange.ExchangeTimeout) as ei:
        dense.dense_shard([rows[0][0]])
    assert ei.value.code == 1 and ei.value.cell == 0


def test_lp_group_missing_a_cell_raises():
    grid = mesh.make_mesh(["cpu"] * 2, eval_parallel=2)
    s_in, _ = mesh.shard_lpq_inputs(grid, *_lp_world(9))
    rows = mesh.lpq_cells(grid, s_in, lpq.lp_temperatures(4))
    with pytest.raises(exchange.ExchangeTimeout) as ei:
        lpq.lp_shard([rows[1][0]])
    assert ei.value.code == 3 and ei.value.cell == 1


def test_error_word_raises_with_its_record():
    err = torch.zeros(ERR_WORDS, dtype=torch.int32)
    exchange.check(err)
    exchange.check(None)
    err[:] = torch.tensor([2, 17, 3, 5], dtype=torch.int32)
    with pytest.raises(exchange.ExchangeTimeout) as ei:
        exchange.check(err)
    assert (ei.value.code, ei.value.step, ei.value.cell, ei.value.lane) == (
        2, 17, 3, 5)
    assert "record" in str(ei.value)
