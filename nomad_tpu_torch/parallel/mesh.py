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
    else the node-sharded scan (solver/dense.py ShardCell): on the card
    one persistent dense_shard launch per card runs every step of every
    cell there, the cells of an evals row meeting through flagged slots
    in their row's exchange area (solver/exchange.py,
    csrc/mesh_exchange.cuh); on the CPU the plain phases read and write
    the same area;
  * ``mesh_lpq`` runs the LP relaxation with lanes on ``evals``, one
    cooperative lp_shard launch per card, the cells of a nodes column
    meeting the same way; ``shard_eval_axis`` splits the wave
    transports' eval axis.

A group's area lives on its card when its cells share one, else in
pinned host memory, which every card maps (``host_exchange`` forces the
host form on one card). Between cells the host copies only the LP's
gather of V and feas and the results; nothing is summed across cells but
integers, so every grid gives the one-card route's bits.

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

from .. import jitcheck
from ..device import resolve_device
from ..solver import dense, exchange, lpq, resident, xferobs

_LOCK = threading.Lock()
_STATS = {"dense_dispatches": 0, "node_sharded_steps": 0,
          "lpq_dispatches": 0, "eval_sharded_dispatches": 0,
          "persistent_launches": 0, "exchange_copies": 0,
          "bytes_shipped_total": 0}


def _stat(name: str, n: int = 1) -> None:
    with _LOCK:
        _STATS[name] += n


def mesh_stats() -> dict:
    """Counts of the mesh route: dispatches per kind, node-sharded steps,
    persistent launches (one per card per node-sharded or LP dispatch),
    the copies the host still makes between cells (the LP's gather of V
    and feas), and the bytes its transports shipped."""
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
# indices into per-axis coordinates; (coords, vals) go to every device
# once, and each cell writes into a copy of its slice the updates that
# land there, all the cells of a device in one call.

def _scatter_cells(buf: Sharded, coords: np.ndarray, vals: np.ndarray,
                   fn) -> Sharded:
    by_dev: dict = {}
    for k, dev, idx in cuts(buf.shape, buf.spec, buf.grid):
        by_dev.setdefault(dev, []).append((k, [s.start for s in idx]))
    parts = [None] * len(buf.parts)
    for dev, cells in by_dev.items():
        outs = fn([buf.parts[k] for k, _ in cells],
                  resident.put_coord_payload(coords, vals, dev),
                  [st for _, st in cells])
        for (k, _), out in zip(cells, outs):
            parts[k] = out
    return Sharded(buf.grid, buf.spec, buf.shape, parts)


def mesh_delta_scatter(buf: Sharded, coords: np.ndarray,
                       vals: np.ndarray) -> Sharded:
    """A new sharded table equal to ``buf`` with ``out[coords[:, i]] =
    vals[i]``; ``coords`` (ndim, k) int32 in whole-table coordinates. Per
    device: one payload upload, then resident.coord_scatter_cells over its
    cells (one launch on a card)."""
    return _scatter_cells(buf, coords, vals, resident.coord_scatter_cells)


@jitcheck.plain_version
def mesh_delta_scatter_plain(buf: Sharded, coords: np.ndarray,
                             vals: np.ndarray) -> Sharded:
    """The plain version of mesh_delta_scatter, on the cells' devices."""
    return _scatter_cells(buf, coords, vals,
                          resident.coord_scatter_cells_plain)


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


def _route(cells) -> str:
    kinds = {c.type for c in cells}
    if kinds == {"cuda"}:
        return "cuda"
    if kinds == {"cpu"}:
        return "cpu"
    raise ValueError(f"a grid over {sorted(kinds)} cells: the mesh kernels "
                     "run on cards, the plain route on the CPU")


def shard_cells(grid: Grid, s: ShardedInputs, cast, *, spread_alg: bool,
                host_exchange: bool = False):
    """The ShardCells of a node-sharded dispatch: per evals row, its cells
    in node order, sharing the row's exchange area (on the row's card, or
    in pinned host memory: exchange.host_form)."""
    rows = []
    for i in range(grid.e_par):
        row_devs = [grid.cell(i, j) for j in range(grid.n_par)]
        area = None
        row = []
        for j in range(grid.n_par):
            c = dense.ShardCell(*(_cell_tree(t, i, j, cast)
                                  for t in (s.const, s.init, s.batch)),
                                j=j, n_par=grid.n_par, spread_alg=spread_alg,
                                area=area, place=i * grid.n_par + j)
            if area is None:
                area = exchange.zeros(
                    exchange.shard_area_words(grid.n_par, c.dims[0],
                                              c.words),
                    row_devs[0], exchange.host_form(row_devs, host_exchange))
                c.bind_area(area)
            row.append(c)
        rows.append(row)
    return rows


def run_node_sharded(rows) -> None:
    """The plain node-sharded scan over ``rows`` (per evals row, its
    ShardCells in node order) on the cells' devices: per placement step
    the three phases on every cell, reading and writing the row's
    exchange area in place (a row built without one gets one:
    dense.share_area)."""
    for row in rows:
        dense.share_area(row)
    dense.shard_steps_plain([c for row in rows for c in row])
    _stat("node_sharded_steps", rows[0][0].chosen.shape[1])


def _launch_per_card(cells, devs, launch_of, host_exchange: bool):
    """One persistent launch per card over ``cells`` (``devs`` their
    devices; ``launch_of(cells_on_card, err)`` gives exchange.launch's
    (device, fn)). Returns the dispatch's error word, for
    exchange.check."""
    err = exchange.error_word(devs[0],
                              exchange.host_form(devs, host_exchange))
    by_dev = {}
    for c, d in zip(cells, devs):
        by_dev.setdefault(str(d), []).append(c)
    exchange.launch([launch_of(cs, err) for cs in by_dev.values()],
                    hold=exchange.pinned([c.area for c in cells] + [err]))
    _stat("persistent_launches", len(by_dev))
    return err


def run_persistent(rows, *, host_exchange: bool = False, budget_s=None):
    """The node-sharded scan over ``rows`` on the card: one dense_shard
    launch per card, covering every cell on it (exchange.launch).
    Returns the dispatch's error word, for exchange.check."""
    cells = [c for row in rows for c in row]
    err = _launch_per_card(
        cells, [c.fin.device for c in cells],
        lambda cs, e: dense.shard_launch(cs, e, budget_s), host_exchange)
    _stat("node_sharded_steps", rows[0][0].chosen.shape[1])
    return err


def mesh_solve(grid: Grid, const, init, batch, *, spread_alg: bool,
               dtype_name: str, cache_version=None, delta_src=None,
               host_exchange: bool = False):
    """Dense greedy solve of stacked (E, ...) numpy lane tables over
    ``grid``: with one node column each eval row runs the dense scan on
    its lanes (the dense_scan kernel on the card), else the node-sharded
    scan: one persistent dense_shard launch per card (the plain phases
    on the CPU). ``host_exchange`` keeps every exchange area in pinned
    host memory even where the cells share a card. Returns host numpy
    (chosen int64, scores, n_yielded int64), each (E, P), gathered in
    cell order; the trailing state stays on the cells. Raises
    exchange.ExchangeTimeout if a wait of the kernel ran out its
    budget."""
    # the range checks and round sizing read the host lanes (one bound
    # for every cell: a cell's own maxima are no larger)
    imax = dense.index_max(const, init, batch)
    s = shard_solver_inputs(grid, const, init, batch,
                            version=cache_version, delta_src=delta_src)
    cast = dense.lane_casts(dtype_name)
    _stat("dense_dispatches")
    err = None
    if grid.n_par == 1:
        outs = []
        for i in range(grid.e_par):
            o = dense.dense_scan(*(_cell_tree(t, i, 0, cast)
                                   for t in (s.const, s.init, s.batch)),
                                 spread_alg=spread_alg, imax=imax)
            outs.append((o.chosen, o.scores, o.n_yielded))
    else:
        rows = shard_cells(grid, s, cast, spread_alg=spread_alg,
                           host_exchange=host_exchange)
        if _route(grid.cells) == "cuda":
            err = run_persistent(rows, host_exchange=host_exchange)
        else:
            run_node_sharded(rows)
        outs = [(r[0].chosen, r[0].scores, r[0].n_yielded) for r in rows]
    # the grid's one read-back (the reference's mesh device_get)
    with jitcheck.sanctioned_fetch("mesh"):
        res = tuple(np.concatenate([o[k].cpu().numpy() for o in outs])
                    for k in range(3))
    exchange.check(err)
    return res


# --------------------------------------------------------------------------
# The LP relaxation over a grid (reference mesh_lpq_fn).

def run_lpq_cells(rows) -> None:
    """The plain lane-sharded relaxation over ``rows`` (per evals row,
    its LpShardCells) on the cells' devices: init, per step every cell's
    rows phase then every cell's nodes phase, reading the group's
    statistics in place (the cells of a nodes column share one area; a
    column built without one gets one here), then the final rows and
    write_x phases."""
    for j in range(len(rows[0])):
        col = [row[j] for row in rows]
        if not all(c.area is col[0].area for c in col):
            devs = [c.V.device for c in col]
            area = exchange.zeros(
                exchange.lp_area_words(len(col), col[0].V.shape[0]),
                devs[0], exchange.host_form(devs))
            for c in col:
                c.bind_area(area)
    lpq.lp_shard_steps_plain([c for row in rows for c in row])


def lpq_cells(grid: Grid, s_in, temps: np.ndarray, *,
              host_exchange: bool = False):
    """The LpShardCells of an LP dispatch, per evals row: each gathers V
    and feas whole (host copies between cells, counted), holds its row's
    lanes, and shares its nodes column's exchange area."""
    V, feas, ask, pcount, free, active = s_in
    L, N = V.shape
    Lc = L // grid.e_par
    areas = []
    for j in range(grid.n_par):
        devs = [grid.cell(i, j) for i in range(grid.e_par)]
        areas.append(exchange.zeros(exchange.lp_area_words(grid.e_par, L),
                                    devs[0],
                                    exchange.host_form(devs, host_exchange)))
    rows, copies = [], 0
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
                copies += 2 if i2 != i else 0
            row.append(lpq.LpShardCell(
                Vf, Ff, ask.part(i, j), pcount.part(i, j), free.part(i, j),
                active.part(i, j), resident._put(temps, dev),
                l0=i * Lc, l1=(i + 1) * Lc, area=areas[j], gi=i,
                G=grid.e_par, place=i * grid.n_par + j))
        rows.append(row)
    _stat("exchange_copies", copies)
    return rows


def mesh_lpq(grid: Grid, s_in, temps: np.ndarray, *,
             host_exchange: bool = False):
    """The LP relaxation with lanes on ``evals``: ``s_in`` the six tables
    of shard_lpq_inputs, ``temps`` the (steps,) float32 temperatures.
    Every cell gathers V and feas whole once, then each step computes
    its lanes' row statistics (max, sum), publishes them to its nodes
    column, and runs the node step over all lanes in order from the
    group's statistics: the one-card kernel's operations in its order,
    so X and mu are its bits. On the card one cooperative lp_shard launch
    per card runs every cell there (the plain phases on the CPU);
    ``host_exchange`` keeps the areas in pinned host memory. Returns (X
    (L, N), mu (N, 3)) float32 on the first cell's device; on the card X
    carries the dispatch's error word as ``X.exchange_error``: the caller
    runs exchange.check on it after reading X and mu back."""
    _stat("lpq_dispatches")
    rows = lpq_cells(grid, s_in, temps, host_exchange=host_exchange)
    cells = [c for row in rows for c in row]
    err = None
    if _route(grid.cells) == "cuda":
        err = _launch_per_card(cells, [c.V.device for c in cells],
                               lpq.lp_shard_launch, host_exchange)
    else:
        run_lpq_cells(rows)
    dev0 = grid.cell(0, 0)
    X = torch.cat([row[0].X.to(dev0) for row in rows])
    if err is not None:
        X.exchange_error = err
    return X, rows[0][0].mu
