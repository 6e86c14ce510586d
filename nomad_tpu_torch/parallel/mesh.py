"""The mesh route: the solver sharded over an (evals, nodes) grid of cells
(port of nomad_tpu/parallel/mesh.py).

A grid is a 2-D array of ``torch.device``s, (e_par, n_par), driven by one
process, as the reference drives its mesh from one controller. The fused
eval axis splits over the e_par rows, the node axis (window order: the
lanes' shuffled order) over the n_par columns. One device may appear in
several cells: on one card every cell is that card, on a host with
several cards each cell can be its own card; the code is the same.

  * ``pick_mesh`` chooses the grid for a dispatch's shapes as the
    reference does: the split that uses the most cells, eval-parallel
    among equals, None below two cells or with NOMAD_TPU_TORCH_MESH=0.
  * ``SPEC_GROUPS`` says which axis of each field shards on ``evals`` and
    which on ``nodes`` (the reference's PartitionSpecs, as tuples); a
    ``Sharded`` table holds one tensor per cell, cut by its spec.
  * ``shard_solver_inputs`` cuts a dense dispatch's const / init / batch
    trees: const through the per-shard resident pool, init through the
    version chain (keyed with the grid; promoted by the coordinate
    scatter), batch fresh.
  * ``mesh_solve`` runs the dense scan: each eval row launches the
    one-card dense_scan on its lanes when the grid has one node column,
    else the node-sharded step (solver/dense.py ShardCell, three phases a
    step).
  * ``mesh_lpq`` runs the LP relaxation with lanes on ``evals``;
    ``shard_eval_axis`` splits the wave transports' eval axis.

Between cells, data moves only as copies into per-cell gather buffers in
cell order (``Tensor.copy_``; across cards PyTorch orders such a copy
after both devices' current streams with events). Nothing is summed
across cells but integers, so every grid gives the one-card route's
bits.

Knob (read at each use):
  NOMAD_TPU_TORCH_MESH   0 refuses every grid: each solve runs on one
                         device (kill switch)
"""
from __future__ import annotations

import os
import threading
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..solver import dense, lpq, resident, xferobs

_LOCK = threading.Lock()
_STATS = {"dense_dispatches": 0, "node_sharded_steps": 0,
          "lpq_dispatches": 0, "eval_sharded_dispatches": 0,
          "exchange_copies": 0, "bytes_shipped_total": 0}


def _stat(name: str, n: int = 1) -> None:
    with _LOCK:
        _STATS[name] += n


def mesh_stats() -> dict:
    """Counts of the mesh route: dispatches per kind, node-sharded steps,
    copies between cells, and the bytes its transports shipped."""
    with _LOCK:
        return dict(_STATS)


def _reset_for_tests() -> None:
    with _LOCK:
        for k in _STATS:
            _STATS[k] = 0


def mesh_enabled() -> bool:
    """The mesh route's switch: with NOMAD_TPU_TORCH_MESH=0 every factory
    here refuses a grid and each solve runs on one device, bit for bit."""
    return os.environ.get("NOMAD_TPU_TORCH_MESH", "1") != "0"


class Grid:
    """An (evals, nodes) grid of cells: ``cells`` in row-major order, so
    cell (i, j) is ``cells[i * n_par + j]`` and its place in the grid is
    the reference's device id."""

    __slots__ = ("cells", "e_par", "n_par")

    def __init__(self, cells: Sequence[torch.device], e_par: int,
                 n_par: int):
        if e_par < 1 or n_par < 1 or len(cells) != e_par * n_par:
            raise ValueError(f"{len(cells)} cells do not make an "
                             f"({e_par}, {n_par}) grid")
        self.cells = tuple(torch.device(c) for c in cells)
        self.e_par, self.n_par = int(e_par), int(n_par)

    @property
    def shape(self):
        return (self.e_par, self.n_par)

    def cell(self, i: int, j: int) -> torch.device:
        return self.cells[i * self.n_par + j]

    @property
    def key(self) -> tuple:
        """Equal for grids of the same shape over the same devices."""
        return (self.shape, tuple(str(c) for c in self.cells))


def make_mesh(devices: Sequence, eval_parallel: Optional[int] = None
              ) -> Grid:
    """An (evals, nodes) grid over ``devices`` (reference make_mesh):
    ``eval_parallel`` rows, or by default the balanced split with the
    larger factor on the eval axis."""
    cells = [resolve_device(d) for d in devices]
    n = len(cells)
    if eval_parallel is None:
        eval_parallel = n
        for cand in range(int(np.floor(np.sqrt(n))), 0, -1):
            if n % cand == 0:
                eval_parallel = n // cand
                break
    if eval_parallel < 1 or n % eval_parallel:
        raise ValueError(f"eval_parallel {eval_parallel} does not divide "
                         f"{n} cells")
    return Grid(cells, eval_parallel, n // eval_parallel)


def pick_mesh(e: int, n: int, devices: Sequence) -> Optional[Grid]:
    """The grid for a dispatch of ``e`` lanes over ``n`` (padded) nodes
    (reference pick_mesh): e_par a divisor of e, n_par the largest
    divisor of n that fits the remaining cells, the split that uses the
    most cells, eval-parallel among equals; None below two cells, or with
    the mesh switched off."""
    if not mesh_enabled():
        return None
    cells = list(devices)
    d = len(cells)
    if d <= 1 or e < 1 or n < 1:
        return None

    def largest_divisor(x: int, cap: int) -> int:
        return next(c for c in range(min(x, cap), 0, -1) if x % c == 0)

    best = (1, 1)
    for e_par in range(min(e, d), 0, -1):
        if e % e_par:
            continue
        n_par = largest_divisor(n, d // e_par)
        if e_par * n_par > best[0] * best[1]:
            best = (e_par, n_par)
    e_par, n_par = best
    if e_par * n_par < 2:
        return None
    return make_mesh(cells[:e_par * n_par], eval_parallel=e_par)


def eval_axis_mesh(devices: Sequence) -> Grid:
    """A grid with every cell on the eval axis (the wave transports shard
    only their fused eval axis)."""
    cells = [resolve_device(d) for d in devices]
    return Grid(cells, len(cells), 1)


# --------------------------------------------------------------------------
# The spec table: per field of each dispatch tree, the grid axis each of
# its axes shards on (None: whole on every cell; () replicated).

EN = ("evals", "nodes")
EV = ("evals",)
ESN = ("evals", None, "nodes")
ERGN = ("evals", None, None, "nodes")
REP = ()


def const_partition_specs(c):
    """NodeConst: per-node columns shard (evals, nodes); per-eval scalars
    and tables without a node axis shard on evals only."""
    return type(c)(
        cpu_cap=EN, mem_cap=EN, disk_cap=EN, feasible=EN, affinity=EN,
        has_affinity=EV, distinct_hosts=EV, distinct_job_level=EV,
        spread_vidx=ESN, spread_desired=EV, spread_has_targets=EV,
        spread_weights=EV, spread_sum_weights=EV, n_spreads=EV,
        dp_vidx=ESN, dp_limit=EV, dp_tg_scope=EV, dev_aff=ERGN,
        dev_count=EV, dev_sum_weight=EV, mhz_per_core=EN)


def state_partition_specs(s):
    """NodeState: usage columns shard (evals, nodes); the spread and
    distinct_property counts are per-eval tables."""
    return type(s)(
        used_cpu=EN, used_mem=EN, used_disk=EN, placed=EN, placed_job=EN,
        static_free=EN, dyn_avail=EN, spread_counts=EV, dp_counts=EV,
        dev_free=ERGN, cores_free=EN)


def batch_partition_specs(b):
    """PlacementBatch: every (E, P) column shards on evals."""
    return type(b)(*(EV for _ in b))


def eval_axis_partition_specs(tree):
    """The wave transports' tables: the leading eval axis only."""
    return tuple(EV for _ in tree)


def lpq_partition_specs(tree):
    """The LP inputs (V, feas, ask, pcount, free, active): V and feas
    shard their lanes on evals, the rest replicate."""
    if len(tree) != 6:
        raise ValueError(f"lpq_in expects the 6-tuple (V, feas, ask, "
                         f"pcount, free, active), got {len(tree)} leaves")
    return (("evals", None), ("evals", None), REP, REP, REP, REP)


SPEC_GROUPS = {
    "mesh_const": const_partition_specs,
    "mesh_init": state_partition_specs,
    "mesh_batch": batch_partition_specs,
    "compact": eval_axis_partition_specs,
    "compact_preempt": eval_axis_partition_specs,
    "lpq_in": lpq_partition_specs,
}


def cell_index(shape, spec, grid: Grid, i: int, j: int) -> tuple:
    """The slices of a ``shape`` table that cell (i, j) holds."""
    idx = []
    for ax, n in enumerate(shape):
        name = spec[ax] if ax < len(spec) else None
        k, p = {"evals": (grid.e_par, i),
                "nodes": (grid.n_par, j)}.get(name, (1, 0))
        if n % k:
            raise ValueError(f"axis {ax} of {tuple(shape)} ({n}) does not "
                             f"split over {k} {name} cells")
        w = n // k
        idx.append(slice(p * w, (p + 1) * w))
    return tuple(idx)


def cuts(shape, spec, grid: Grid) -> list:
    """(place, device, slices) of every cell, in grid order."""
    return [(i * grid.n_par + j, grid.cell(i, j),
             cell_index(shape, spec, grid, i, j))
            for i in range(grid.e_par) for j in range(grid.n_par)]


class Sharded:
    """A table cut over a grid: ``parts[k]`` is cell k's slice, a tensor
    on that cell's device (cells that hold the same slice hold copies)."""

    __slots__ = ("grid", "spec", "shape", "parts")

    def __init__(self, grid: Grid, spec, shape, parts):
        self.grid, self.spec = grid, tuple(spec)
        self.shape, self.parts = tuple(shape), list(parts)

    def part(self, i: int, j: int) -> torch.Tensor:
        return self.parts[i * self.grid.n_par + j]

    def cpu(self) -> torch.Tensor:
        """The whole table on the host, assembled from the cells."""
        out = torch.empty(self.shape, dtype=self.parts[0].dtype)
        for k, _dev, idx in cuts(self.shape, self.spec, self.grid):
            out[idx] = self.parts[k].cpu()
        return out


def put_by_spec(arr: np.ndarray, spec, grid: Grid) -> Sharded:
    """Ship ``arr`` to the grid, each cell its slice (a copy)."""
    arr = np.asarray(arr)
    parts = [resident._put(np.ascontiguousarray(arr[idx]), dev)
             for _k, dev, idx in cuts(arr.shape, spec, grid)]
    return Sharded(grid, spec, arr.shape, parts)


# --------------------------------------------------------------------------
# The coordinate scatter (reference mesh_delta_scatter_fn): the version
# chain's promotion of a sharded table. The host unravels the flat diff
# indices into per-axis coordinates; (coords, vals) go to every cell, and
# each cell writes into a copy of its slice the updates that land there.

def _scatter_cells(buf: Sharded, coords: np.ndarray, vals: np.ndarray,
                   fn) -> Sharded:
    parts = []
    for k, dev, idx in cuts(buf.shape, buf.spec, buf.grid):
        parts.append(fn(buf.parts[k], resident._put(coords, dev),
                        resident._put(vals, dev), [s.start for s in idx]))
    return Sharded(buf.grid, buf.spec, buf.shape, parts)


def mesh_delta_scatter(buf: Sharded, coords: np.ndarray,
                       vals: np.ndarray) -> Sharded:
    """A new sharded table equal to ``buf`` with ``out[coords[:, i]] =
    vals[i]``; ``coords`` (ndim, k) int32 in whole-table coordinates. Each
    cell runs resident.coord_scatter (the kernel on the card)."""
    return _scatter_cells(buf, coords, vals, resident.coord_scatter)


def mesh_delta_scatter_plain(buf: Sharded, coords: np.ndarray,
                             vals: np.ndarray) -> Sharded:
    """The plain version of mesh_delta_scatter, on the cells' devices."""
    return _scatter_cells(buf, coords, vals, resident.coord_scatter_plain)


# --------------------------------------------------------------------------
# Transports.

class ShardedInputs(NamedTuple):
    const: tuple        # NodeConst of Sharded
    init: tuple         # NodeState of Sharded
    batch: tuple        # PlacementBatch of Sharded
    shipped: int        # bytes that crossed to the cells


def _note_rows(group: str, leaves, specs, grid: Grid) -> None:
    """The ledger's per-cell rows of a tree cut by ``specs``."""
    resident.note_cell_rows(group, [
        (a, [idx for _k, _d, idx in cuts(np.shape(a), sp, grid)])
        for a, sp in zip(leaves, specs)])


def _put_fresh(group: str, tree, grid: Grid):
    specs = SPEC_GROUPS[group](tree)
    leaves = [np.asarray(a) for a in tree]
    total = sum(a.nbytes for a in leaves)
    if xferobs.enabled():
        xferobs.note_payload(group, total)
        _note_rows(group, leaves, specs, grid)
    resident.note_dispatch_bytes(total)
    out = type(tree)(*(put_by_spec(a, sp, grid)
                       for a, sp in zip(leaves, specs)))
    return out, total


def _put_chain(group: str, tree, grid: Grid, delta_src):
    """The usage tree through the version chain (reference put_chain):
    each large leaf keeps its sharded buffer per slot, keyed with the
    grid (a new grid installs anew), and a journal-covered generation
    ships only the changed elements, scattered by coordinates. The
    fused arena refills these host buffers, so the shadows are copies."""
    store = token = None
    if delta_src is not None and resident.delta_stream_enabled():
        store, token = delta_src
        if token is None or not hasattr(store, "alloc_deltas_since"):
            store = token = None
    if store is None:
        return _put_fresh(group, tree, grid)
    def scatter(buf, shape, idx_p, vals_p):
        # a sharded table is never flattened: unravel the flat diff
        # indices into per-axis coordinates
        coords = np.ascontiguousarray(np.stack(np.unravel_index(
            idx_p.astype(np.int64), shape)).astype(np.int32))
        return mesh_delta_scatter(buf, coords, vals_p)

    specs = SPEC_GROUPS[group](tree)
    min_b = resident._min_bytes()
    bufs = []
    shipped = small_total = 0
    for j, (leaf, spec) in enumerate(zip(tree, specs)):
        arr = np.asarray(leaf)
        if arr.nbytes < min_b:
            # small leaves are the delta traffic: ship them by spec
            bufs.append(put_by_spec(arr, spec, grid))
            shipped += arr.nbytes
            small_total += arr.nbytes
            continue
        buf, ship_j, _outcome = resident.chain_apply(
            (group, arr.dtype.str, arr.shape, j, grid.key), arr, store,
            token, put_fn=lambda a, _s=spec: put_by_spec(a, _s, grid),
            scatter=scatter, idx_width=4 * max(1, arr.ndim),
            copy_shadow=True, tag=group)
        bufs.append(buf)
        shipped += ship_j
    if xferobs.enabled():
        if small_total:
            xferobs.note_payload(group, small_total)
        _note_rows(group, [np.asarray(a) for a in tree], specs, grid)
    resident.note_dispatch_bytes(shipped)
    return type(tree)(*bufs), shipped


def shard_solver_inputs(grid: Grid, const, init, batch, version=None,
                        delta_src=None) -> ShardedInputs:
    """Cut a dense dispatch's stacked numpy trees over ``grid`` by the
    spec table: const through the per-shard resident pool (``version``
    the node table's index), init through the version chain when
    ``delta_src`` = (store, token) is given, batch fresh."""
    specs = SPEC_GROUPS["mesh_const"](const)
    leaves = [np.asarray(a) for a in const]
    parts, shipped = resident.device_put_sharded_cached(
        leaves, [cuts(a.shape, sp, grid) for a, sp in zip(leaves, specs)],
        version=version,
        fallback_put=lambda k: put_by_spec(leaves[k], specs[k], grid).parts)
    s_const = type(const)(*(Sharded(grid, sp, a.shape, p)
                            for a, sp, p in zip(leaves, specs, parts)))
    s_init, ship_i = _put_chain("mesh_init", init, grid, delta_src)
    s_batch, ship_b = _put_fresh("mesh_batch", batch, grid)
    total = shipped + ship_i + ship_b
    _stat("bytes_shipped_total", total)
    return ShardedInputs(s_const, s_init, s_batch, total)


def shard_lpq_inputs(grid: Grid, V, feas, ask, pcount, free, active):
    """Cut the LP inputs by the ``lpq_in`` specs (fresh: V and feas
    change every solve). Returns (six Sharded tables, bytes shipped)."""
    tree = (V, feas, ask, pcount, free, active)
    specs = SPEC_GROUPS["lpq_in"](tree)
    out = tuple(put_by_spec(a, sp, grid) for a, sp in zip(tree, specs))
    total = sum(np.asarray(a).nbytes for a in tree)
    if xferobs.enabled():
        xferobs.note_payload("lpq", total)
        _note_rows("lpq", tree, specs, grid)
    resident.note_dispatch_bytes(total)
    _stat("bytes_shipped_total", total)
    return out, total


def shard_eval_axis(arrays: Sequence[np.ndarray], cells: Sequence,
                    tag: str = "compact"):
    """Split the wave transports' tables on their leading eval axis over
    ``cells`` (fresh, no cache). Returns (per cell the list of its
    tensors, bytes shipped). ``tag`` names the tree group."""
    grid = eval_axis_mesh(cells)
    specs = SPEC_GROUPS[tag](arrays)
    sh = [put_by_spec(a, sp, grid) for a, sp in zip(arrays, specs)]
    total = sum(np.asarray(a).nbytes for a in arrays)
    resident.note_dispatch_bytes(total)
    xferobs.note_payload(tag, total)
    _stat("bytes_shipped_total", total)
    _stat("eval_sharded_dispatches")
    return [[t.parts[k] for t in sh] for k in range(len(grid.cells))], total


# --------------------------------------------------------------------------
# The dense scan over a grid (reference mesh_solve_fn).

def _cell_tree(tree, i: int, j: int, cast):
    vals = []
    for f, sh in zip(type(tree)._fields, tree):
        t = sh.part(i, j)
        want = cast(f)
        if want is not None and t.dtype != want:
            t = t.to(want)
        vals.append(t)
    return type(tree)(*vals)


def _exchange(rows, name: str) -> None:
    """Copy each cell's own slot of buffer ``name`` into every other cell
    of its evals row (the gather, in cell order)."""
    n = 0
    for row in rows:
        for dst in row:
            for src in row:
                if src is not dst:
                    getattr(dst, name)[src.j].copy_(
                        getattr(src, name)[src.j], non_blocking=True)
                    n += 1
    _stat("exchange_copies", n)


def run_node_sharded(rows, phase_fn=None) -> None:
    """Drive the node-sharded scan over ``rows`` (per evals row, its
    ShardCells in node order): per placement step the three phases on
    every cell, each followed by the copies of its exchange buffer.
    ``phase_fn(cell, phase, step)`` runs a phase (dense.shard_phase: the
    kernel on the card)."""
    phase_fn = phase_fn or dense.shard_phase
    P = rows[0][0].chosen.shape[1]
    for step in range(P):
        for phase, name in ((dense.SHARD_COUNT, "cnt"),
                            (dense.SHARD_SELECT, "rec"),
                            (dense.SHARD_COMMIT, None)):
            for row in rows:
                for c in row:
                    phase_fn(c, phase, step)
            if name is not None:
                _exchange(rows, name)
    _stat("node_sharded_steps", P)


def mesh_solve(grid: Grid, const, init, batch, *, spread_alg: bool,
               dtype_name: str, cache_version=None, delta_src=None):
    """Dense greedy solve of stacked (E, ...) numpy lane tables over
    ``grid``: with one node column each eval row runs the dense scan on
    its lanes (the dense_scan kernel on the card), else the node-sharded
    step runs its three phases a step on every cell. Returns host numpy
    (chosen int64, scores, n_yielded int64), each (E, P), gathered in
    cell order; the trailing state stays on the cells."""
    s = shard_solver_inputs(grid, const, init, batch,
                            version=cache_version, delta_src=delta_src)
    cast = dense.lane_casts(dtype_name)
    _stat("dense_dispatches")

    def trees(i, j):
        return (_cell_tree(s.const, i, j, cast),
                _cell_tree(s.init, i, j, cast),
                _cell_tree(s.batch, i, j, cast))

    if grid.n_par == 1:
        outs = []
        for i in range(grid.e_par):
            o = dense.dense_scan(*trees(i, 0), spread_alg=spread_alg)
            outs.append((o.chosen, o.scores, o.n_yielded))
    else:
        rows = [[dense.ShardCell(*trees(i, j), j=j, n_par=grid.n_par,
                                 spread_alg=spread_alg)
                 for j in range(grid.n_par)] for i in range(grid.e_par)]
        run_node_sharded(rows)
        outs = [(r[0].chosen, r[0].scores, r[0].n_yielded) for r in rows]
    return tuple(np.concatenate([o[k].cpu().numpy() for o in outs])
                 for k in range(3))


# --------------------------------------------------------------------------
# The LP relaxation over a grid (reference mesh_lpq_fn).

def run_lpq_cells(rows, steps: int, phase_fn=None) -> None:
    """Drive the lane-sharded relaxation over ``rows`` (per evals row,
    its LpShardCells): init, per step every cell's rows phase, the copies
    of every row's statistics into every cell in lane order, every
    cell's nodes phase; then the final rows and write_x phases.
    ``phase_fn(cell, phase, t)`` runs a phase (lpq.lp_shard_phase: the
    kernel on the card)."""
    phase_fn = phase_fn or lpq.lp_shard_phase
    cells = [c for row in rows for c in row]

    def gather_stats():
        n = 0
        for i, row in enumerate(rows):
            for j, dst in enumerate(row):
                for i2, src_row in enumerate(rows):
                    if i2 == i:
                        continue
                    src = src_row[j]
                    rs = slice(src.l0, src.l1)
                    dst.rmax[rs].copy_(src.rmax[rs], non_blocking=True)
                    dst.rsum[rs].copy_(src.rsum[rs], non_blocking=True)
                    n += 2
        _stat("exchange_copies", n)

    for c in cells:
        phase_fn(c, lpq.LP_INIT, 0)
    for t in range(steps):
        for c in cells:
            phase_fn(c, lpq.LP_ROWS, t)
        gather_stats()
        for c in cells:
            phase_fn(c, lpq.LP_NODES, t)
    for c in cells:
        phase_fn(c, lpq.LP_ROWS, -1)
        phase_fn(c, lpq.LP_WRITE_X, -1)


def mesh_lpq(grid: Grid, s_in, temps: np.ndarray):
    """The LP relaxation with lanes on ``evals``: ``s_in`` the six tables
    of shard_lpq_inputs, ``temps`` the (steps,) float32 temperatures.
    Every cell gathers V and feas whole once, then each step computes
    its lanes' row statistics (max, sum), gathers every row's into lane
    order, and runs the node step over all lanes in order: the one-card
    kernel's operations in its order, so X and mu are its bits. Returns
    (X (L, N), mu (N, 3)) float32 on the first cell's device."""
    V, feas, ask, pcount, free, active = s_in
    L, N = V.shape
    Lc = L // grid.e_par
    steps = int(temps.shape[0])
    _stat("lpq_dispatches")
    rows = []
    for i in range(grid.e_par):
        row = []
        for j in range(grid.n_par):
            dev = grid.cell(i, j)
            Vf = torch.empty((L, N), dtype=torch.float32, device=dev)
            Ff = torch.empty((L, N), dtype=torch.bool, device=dev)
            for i2 in range(grid.e_par):
                rs = slice(i2 * Lc, (i2 + 1) * Lc)
                Vf[rs].copy_(V.part(i2, j), non_blocking=True)
                Ff[rs].copy_(feas.part(i2, j), non_blocking=True)
            row.append(lpq.LpShardCell(
                Vf, Ff, ask.part(i, j), pcount.part(i, j), free.part(i, j),
                active.part(i, j), resident._put(temps, dev),
                l0=i * Lc, l1=(i + 1) * Lc))
        rows.append(row)
    run_lpq_cells(rows, steps)
    dev0 = grid.cell(0, 0)
    X = torch.cat([row[0].X.to(dev0) for row in rows])
    return X, rows[0][0].mu
