"""Dense greedy placement: the dense scan kernel, its plain PyTorch
version, and the wrapper that picks between them (port of
nomad_tpu/solver/binpack.py _solve_placements_impl with _scoring_parts,
_select_window, _window_outputs, _spread_score and _commit_tables).

Every placement step rescores all N nodes of a lane against the lane's
current usage -- fit over cpu/mem/disk, dynamic and static ports,
distinct_hosts, distinct_property counts, device groups and reserved
cores; score = binpack + anti-affinity + reschedule penalty + affinity +
spread + device affinity, divided by the number of terms present --
selects within the LimitIterator/MaxScoreIterator window, and commits the
winner into the carried NodeState. This is the path for lanes the
wavefront gate refuses (service.PackedLane.wavefront_ok).

The reference's FAST_T shortcut (binpack.py:432-438, :671-687) scores
only the first 1,024 positions when they already hold ``limit`` counted
options; its outcome is identical to the full pass. The plain version
here always runs the full pass; the kernel walks the nodes in rounds and
stops once ``limit`` options are counted, the same argument for any
prefix.

``dense_scan_plain`` is batched over the E lanes and loops over the P
steps; the CUDA kernel (csrc/dense_scan.cu) runs one thread-block
cluster per lane with the whole scan inside one launch, each step's walk
split over the cluster's blocks (tests/test_torch_dense_cluster.py
models that split on the CPU). ``dense_scan`` takes the
plain version only for CPU tensors; a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import jitcheck, kernels
from ..device import DeviceLike, default_dtype_name, resolve_device
from . import exchange, resident
from .binpack import NodeConst, NodeState, PlacementBatch
from .scoring import (
    MAX_SKIP, SKIP_THRESHOLD, _BIG, _anti, _binpack_raw, _fma, _score,
    _select, _spread_boost, _winner)


class DenseOut(NamedTuple):
    chosen: torch.Tensor        # (E, P) int64, -1 where nothing placed
    scores: torch.Tensor        # (E, P) best yielded score, -inf if none
    n_yielded: torch.Tensor     # (E, P) int64
    state: NodeState            # the carried usage after the last step


class IndexMax(NamedTuple):
    """The largest entry of a dispatch's index tables and of its limits
    (-1 for an empty table), taken on the host from the packed numpy
    lanes before they ship: the kernels' range checks and dense_scan's
    round sizing read these, never the device tensors (a ``max()`` read
    back from the card would sync the host inside the dispatch)."""
    spread_vidx: int
    dp_vidx: int
    penalty_idx: int
    limit: int
    grp: int = -1               # the preemption tables' group index


def _max_of(a) -> int:
    if isinstance(a, torch.Tensor):
        return int(a.max()) if a.numel() else -1
    a = np.asarray(a)
    return int(a.max()) if a.size else -1


def index_max(const, init, batch, ptab=None) -> IndexMax:
    """IndexMax of stacked lane tables: numpy on the dispatch path (host
    reads); tensors where a caller holds nothing else (on a card that
    reads back from it, so the dispatch path never takes this form)."""
    return IndexMax(_max_of(const.spread_vidx), _max_of(const.dp_vidx),
                    _max_of(batch.penalty_idx), _max_of(batch.limit),
                    -1 if ptab is None else _max_of(ptab.grp))


def check_index_max(pairs) -> None:
    """Raise where a table holds an index past its range: ``pairs`` of
    (name, largest entry, exclusive bound)."""
    for name, m, hi in pairs:
        if m >= hi:
            raise ValueError(f"{name} holds an index >= {hi}")


def _dev_terms(const, state, neg_inf):
    """Device fit and score per node (feasible.go:1270 + device.go): every
    request needs a group with enough free instances; the best such
    group's affinity per request, summed over requests in order, over the
    sum of weights. Returns (ok (E, N) bool, dev_score (E, N))."""
    free = state.dev_free                              # (E, R, Gd, N)
    ok_g = free >= const.dev_count[:, :, None, None]
    any_g = ok_g.any(dim=2)                            # (E, R, N)
    best = torch.where(ok_g, const.dev_aff, neg_inf).max(dim=2).values
    sum_aff = torch.zeros_like(best[:, 0])
    for r in range(best.shape[1]):
        sum_aff = sum_aff + torch.where(any_g[:, r], best[:, r],
                                        torch.zeros_like(best[:, r]))
    sw = const.dev_sum_weight[:, None]
    dev_score = torch.where(sw > 0, sum_aff / sw.clamp_min(1e-9),
                            torch.zeros_like(sum_aff))
    return any_g.all(dim=1), dev_score


def _step_fit(const, state, b):
    """One step's per-node fit (binpack.py _scoring_parts), (E, N) each:
    (feas, fit, new_cpu, new_mem, new_disk, dev_score). ``feas`` is the
    part no eviction can rescue (constraints, ports, distinct_hosts,
    distinct_property, devices, cores); ``dev_score`` is None when the
    lane asks for no devices. ``b`` holds the step's (E, 1) asks."""
    dt = const.cpu_cap.dtype
    E, N = const.cpu_cap.shape
    dev = const.cpu_cap.device
    has_cores = const.mhz_per_core.shape[-1] > 0
    eff_cpu = (_fma(b["ask_cores"].to(dt), const.mhz_per_core, b["ask_cpu"])
               if has_cores else b["ask_cpu"])
    new_cpu = state.used_cpu + eff_cpu
    new_mem = state.used_mem + b["ask_mem"]
    new_disk = state.used_disk + b["ask_disk"]
    distinct = torch.where(const.distinct_job_level[:, None],
                           state.placed_job, state.placed)
    feas = (const.feasible
            & (state.dyn_avail >= b["n_dyn"])
            & (state.static_free | ~b["has_static"])
            & (~const.distinct_hosts[:, None] | (distinct == 0)))
    ar = torch.arange(E, device=dev)[:, None]
    for d in range(const.dp_vidx.shape[1]):
        vidx = const.dp_vidx[:, d].long()
        cnt = state.dp_counts[:, d][ar, vidx.clamp_min(0)]
        feas = feas & (vidx >= 0) & (cnt < const.dp_limit[:, d:d + 1])
    dev_score = None
    if const.dev_aff.shape[1]:
        neg_inf = torch.tensor(-float("inf"), dtype=dt, device=dev)
        dev_ok, dev_score = _dev_terms(const, state, neg_inf)
        feas = feas & dev_ok
    if has_cores:
        feas = feas & (state.cores_free >= b["ask_cores"])
    fit = (feas & (new_cpu <= const.cpu_cap) & (new_mem <= const.mem_cap)
           & (new_disk <= const.disk_cap))
    return feas, fit, new_cpu, new_mem, new_disk, dev_score


def _step_terms(const, state, b, idx, dev_score):
    """The score terms other than binpack at the nodes ``idx`` (a
    nonzero() tuple over (E, N)): (other, nscores), summed in the
    reference's order ((anti + resched) + affinity) + spread [+ device
    affinity]."""
    dt = const.cpu_cap.dtype
    E, N = const.cpu_cap.shape
    dev = const.cpu_cap.device
    coll = state.placed[idx].to(dt)
    count = b["count"].to(dt).expand(E, N)[idx]
    anti = _anti(coll, count)
    pen = torch.arange(N, device=dev)[None, :] == b["penalty"]
    is_pen = pen[idx]
    resched = torch.where(is_pen, -1.0, 0.0).to(dt)
    aff = torch.where(const.has_affinity[:, None], const.affinity,
                      torch.zeros_like(const.affinity))[idx]
    spread = torch.zeros_like(coll)
    S = const.spread_vidx.shape[1]
    if S:
        wfrac = (const.spread_weights
                 / const.spread_sum_weights.clamp_min(1e-9)[:, None])
        for s in range(S):
            boost = _spread_boost(
                const.spread_vidx[:, s].long(), state.spread_counts[:, s],
                const.spread_desired[:, s],
                const.spread_has_targets[:, s:s + 1], wfrac[:, s:s + 1])
            spread = spread + boost[idx]
    nscores = (1.0 + (coll > 0).to(dt) + is_pen.to(dt)
               + (aff != 0.0).to(dt) + (spread != 0.0).to(dt))
    other = ((anti + resched) + aff) + spread
    if dev_score is not None:
        nscores = nscores + (const.dev_sum_weight[:, None] > 0).to(
            dt).expand(E, N)[idx]
        other = other + dev_score[idx]
    return other, nscores


def _free(new, cap):
    """1 - new / max(cap, 1e-9): a node's free share after the ask."""
    return 1.0 - new / cap.clamp_min(1e-9)


def _step_scores(const, state, b, spread_alg):
    """One step's per-node fit and final score (binpack.py
    _scoring_parts), (E, N) each. ``b`` holds the step's (E, 1) asks."""
    _, fit, new_cpu, new_mem, _, dev_score = _step_fit(const, state, b)
    # only fit nodes' scores reach an output; the others are left 0
    # (skipping them keeps the CPU version's libm calls to the fit nodes)
    idx = torch.nonzero(fit, as_tuple=True)
    other, nscores = _step_terms(const, state, b, idx, dev_score)
    bp = _binpack_raw(_free(new_cpu, const.cpu_cap)[idx],
                      _free(new_mem, const.mem_cap)[idx], spread_alg)
    final = torch.zeros(fit.shape, dtype=new_cpu.dtype,
                        device=new_cpu.device)
    final[idx] = _score(bp, other, nscores)
    return fit, final


def _commit(const, state, b, w, do):
    """Commit each lane's winner ``w`` where ``do`` (binpack.py step's
    scatter updates and _commit_tables), in place on ``state``."""
    _commit_usage(const, state, b, w, do)
    _commit_tables(const, state, w, do)


def _commit_usage(const, state, b, w, do):
    """The winner's usage, placed counts, ports and cores, in place."""
    dt = const.cpu_cap.dtype
    E = w.shape[0]
    ar = torch.arange(E, device=w.device)
    add_f = do.to(dt)
    add_i = do.to(torch.int32)
    if const.mhz_per_core.shape[-1]:
        eff = _fma(b["ask_cores"][:, 0].to(dt), const.mhz_per_core[ar, w],
                   b["ask_cpu"][:, 0])
    else:
        eff = b["ask_cpu"][:, 0]
    state.used_cpu[ar, w] += add_f * eff
    state.used_mem[ar, w] += add_f * b["ask_mem"][:, 0]
    state.used_disk[ar, w] += add_f * b["ask_disk"][:, 0]
    state.placed[ar, w] += add_i
    state.placed_job[ar, w] += add_i
    state.static_free[ar, w] &= ~(do & b["has_static"][:, 0])
    state.dyn_avail[ar, w] -= add_i * b["n_dyn"][:, 0]
    if const.mhz_per_core.shape[-1]:
        state.cores_free[ar, w] -= add_i * b["ask_cores"][:, 0]


def _commit_tables(const, state, w, do):
    """Commit the winner ``w``'s spread, distinct_property and device
    tables where ``do`` (binpack.py _commit_tables), in place."""
    _commit_counts(state, _vidx_at(const.spread_vidx, w),
                   _vidx_at(const.dp_vidx, w), do)
    _commit_devices(const, state, w, do)


def _vidx_at(vidx, w):
    """(E, K) value indices of each lane's node ``w`` in an (E, K, N)
    table ((E, 0) when the table has none)."""
    E = w.shape[0]
    if vidx.dim() != 3 or vidx.shape[1] == 0:
        return torch.zeros((E, 0), dtype=torch.int32, device=w.device)
    return vidx[torch.arange(E, device=w.device), :, w]


def _commit_counts(state, sp_v, dp_v, do):
    """Add one to the spread and distinct_property counts of the value
    indices ``sp_v`` (E, S) and ``dp_v`` (E, Dp) where ``do``."""
    E = do.shape[0]
    ar = torch.arange(E, device=do.device)
    for vals, counts in ((sp_v, state.spread_counts),
                         (dp_v, state.dp_counts)):
        for s in range(vals.shape[1]):
            v = vals[:, s].long()
            counts[ar, s, v.clamp_min(0)] += (do & (v >= 0)).to(torch.int32)


def _commit_devices(const, state, w, do):
    """Take the winner's device instances from the group with the first
    maximal affinity among those with room, per request, where ``do``."""
    R = const.dev_aff.shape[1] if const.dev_aff.dim() == 4 else 0
    if not R:
        return
    E = w.shape[0]
    ar = torch.arange(E, device=w.device)
    add_i = do.to(torch.int32)
    free_c = state.dev_free[ar, :, :, w]               # (E, R, Gd)
    ok = free_c >= const.dev_count[:, :, None]
    neg_inf = torch.tensor(-float("inf"), dtype=const.dev_aff.dtype,
                           device=w.device)
    aff_c = torch.where(ok, const.dev_aff[ar, :, :, w], neg_inf)
    g_star = aff_c.argmax(dim=2)                       # (E, R) first max
    for r in range(R):
        state.dev_free[ar, r, g_star[:, r], w] -= (
            add_i * const.dev_count[:, r])


def _step_asks(batch, i, has_cores):
    """Step i's asks, (E, 1) each (the scan's ``b``)."""
    col = slice(i, i + 1)
    return dict(ask_cpu=batch.ask_cpu[:, col], ask_mem=batch.ask_mem[:, col],
                ask_disk=batch.ask_disk[:, col],
                n_dyn=batch.n_dyn_ports[:, col],
                has_static=batch.has_static[:, col],
                count=batch.count[:, col],
                penalty=batch.penalty_idx[:, col].long(),
                ask_cores=(batch.ask_cores[:, col] if has_cores else None))


@jitcheck.plain_version
def dense_scan_plain(const: NodeConst, init: NodeState,
                     batch: PlacementBatch, *, spread_alg: bool) -> DenseOut:
    """Plain PyTorch version of the dense greedy scan over E stacked
    lanes (every tensor carries a leading E axis): one Python step per
    placement, the full node pass every step. ``init`` is not modified."""
    state = NodeState(*(t.clone() for t in init))
    E, P = batch.ask_cpu.shape
    dt = const.cpu_cap.dtype
    dev = const.cpu_cap.device
    has_cores = const.mhz_per_core.shape[-1] > 0
    neg_inf = torch.tensor(-float("inf"), dtype=dt, device=dev)
    chosen = torch.full((E, P), -1, dtype=torch.long, device=dev)
    scores = torch.empty((E, P), dtype=dt, device=dev)
    n_yielded = torch.empty((E, P), dtype=torch.long, device=dev)
    for i in range(P):
        col = slice(i, i + 1)
        b = _step_asks(batch, i, has_cores)
        fit, final = _step_scores(const, state, b, spread_alg)
        _, yielded, order, ny = _select(final, fit,
                                        batch.limit[:, col].long())
        w, best = _winner(torch.where(yielded, final, neg_inf), yielded,
                          order)
        any_yield = ny > 0
        do = batch.active[:, i] & any_yield
        chosen[:, i] = torch.where(do, w, -1)
        scores[:, i] = torch.where(any_yield, best, neg_inf)
        n_yielded[:, i] = ny
        _commit(const, state, b, w, do)
    return DenseOut(chosen, scores, n_yielded, state)


# --------------------------------------------------------------------------
# The wrapper: the plain version for CPU tensors, the CUDA kernel for CUDA
# tensors, an error for anything else.

# (tree, field) order of the tensor pointers nt_dense_scan_* takes; the
# kernel's host code unpacks them in this order (csrc/dense_scan.cu)
DENSE_ARGS = (
    ("const", "cpu_cap"), ("const", "mem_cap"), ("const", "disk_cap"),
    ("const", "feasible"), ("const", "affinity"), ("const", "has_affinity"),
    ("const", "distinct_hosts"), ("const", "distinct_job_level"),
    ("const", "spread_vidx"), ("const", "spread_desired"),
    ("const", "spread_has_targets"), ("const", "spread_weights"),
    ("const", "spread_sum_weights"), ("const", "dp_vidx"),
    ("const", "dp_limit"), ("const", "dev_aff"), ("const", "dev_count"),
    ("const", "dev_sum_weight"), ("const", "mhz_per_core"),
    ("batch", "ask_cpu"), ("batch", "ask_mem"), ("batch", "ask_disk"),
    ("batch", "n_dyn_ports"), ("batch", "has_static"), ("batch", "limit"),
    ("batch", "count"), ("batch", "penalty_idx"), ("batch", "active"),
    ("batch", "ask_cores"),
    ("state", "used_cpu"), ("state", "used_mem"), ("state", "used_disk"),
    ("state", "placed"), ("state", "placed_job"), ("state", "static_free"),
    ("state", "dyn_avail"), ("state", "spread_counts"),
    ("state", "dp_counts"), ("state", "dev_free"), ("state", "cores_free"),
)

_INT_FIELDS = {"spread_vidx", "dp_vidx", "dp_limit", "dev_count",
               "n_dyn_ports", "limit", "count", "penalty_idx", "ask_cores",
               "placed", "placed_job", "dyn_avail", "spread_counts",
               "dp_counts", "dev_free", "cores_free"}
_BOOL_FIELDS = {"feasible", "has_affinity", "distinct_hosts",
                "distinct_job_level", "spread_has_targets", "has_static",
                "active", "static_free"}


def _field_dtype(name, dt):
    if name in _INT_FIELDS:
        return torch.int32
    if name in _BOOL_FIELDS:
        return torch.bool
    return dt


def dense_dims(const, init, batch):
    """(E, N, P, S, V, Dp, Vd, R, Gd, has_cores) of stacked lane tables,
    after checking that every table agrees with them."""
    E, N = const.cpu_cap.shape
    P = batch.ask_cpu.shape[1]
    S, V = init.spread_counts.shape[1:]
    Dp = const.dp_vidx.shape[1] if const.dp_vidx.dim() == 3 else 0
    Vd = init.dp_counts.shape[2] if Dp else 0
    R = const.dev_aff.shape[1] if const.dev_aff.dim() == 4 else 0
    Gd = const.dev_aff.shape[2] if R else 0
    has_cores = const.mhz_per_core.dim() == 2 and const.mhz_per_core.shape[1]
    want = {
        "spread_vidx": (E, S, N), "spread_desired": (E, S, V),
        "spread_has_targets": (E, S), "spread_weights": (E, S),
        "spread_sum_weights": (E,), "has_affinity": (E,),
        "distinct_hosts": (E,), "distinct_job_level": (E,),
        "spread_counts": (E, S, V),
    }
    for f in ("cpu_cap", "mem_cap", "disk_cap", "feasible", "affinity"):
        want[f] = (E, N)
    for f in ("used_cpu", "used_mem", "used_disk", "placed", "placed_job",
              "static_free", "dyn_avail"):
        want[f] = (E, N)
    for f in PlacementBatch._fields:
        want[f] = (E, P)
    if Dp:
        want.update(dp_vidx=(E, Dp, N), dp_limit=(E, Dp),
                    dp_counts=(E, Dp, Vd))
    if R:
        want.update(dev_aff=(E, R, Gd, N), dev_count=(E, R),
                    dev_sum_weight=(E,), dev_free=(E, R, Gd, N))
    if has_cores:
        want.update(mhz_per_core=(E, N), cores_free=(E, N))
    else:
        want.pop("ask_cores")
    trees = {"const": const, "state": init, "batch": batch}
    for tree, f in DENSE_ARGS:
        if f in want and tuple(getattr(trees[tree], f).shape) != want[f]:
            raise ValueError(f"{tree}.{f} has shape "
                             f"{tuple(getattr(trees[tree], f).shape)}, "
                             f"expected {want[f]}")
    return E, N, P, S, V, Dp, Vd, R, Gd, int(bool(has_cores))


def dense_scan(const: NodeConst, init: NodeState, batch: PlacementBatch,
               *, spread_alg: bool, imax: IndexMax = None) -> DenseOut:
    """Dense greedy scan over E stacked lanes of tensors on one device:
    the plain version for CPU tensors, the dense_scan kernel for CUDA
    tensors. ``init`` is not modified. ``imax``: the tables' IndexMax,
    taken on the host before the upload (left out, it is read from the
    tensors)."""
    dt = const.cpu_cap.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"cpu_cap dtype {dt} is not float32/float64")
    dev = const.cpu_cap.device
    trees = {"const": const, "state": init, "batch": batch}
    for tree, f in DENSE_ARGS:
        t = getattr(trees[tree], f)
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{tree}.{f} must be a torch.Tensor")
        if t.device != dev:
            raise ValueError(f"{tree}.{f} is on {t.device}, expected {dev}")
        if t.numel() and t.dtype != _field_dtype(f, dt):
            raise TypeError(f"{tree}.{f} has dtype {t.dtype}, expected "
                            f"{_field_dtype(f, dt)}")
    dims = dense_dims(const, init, batch)
    if dev.type == "cpu":
        return dense_scan_plain(const, init, batch, spread_alg=spread_alg)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    # the kernel indexes count tables with these: keep them in range
    if imax is None:
        imax = index_max(const, init, batch)
    N, V, Vd = dims[1], dims[4], dims[6]
    check_index_max((("spread_vidx", imax.spread_vidx, V),
                     ("dp_vidx", imax.dp_vidx, Vd),
                     ("penalty_idx", imax.penalty_idx, N)))
    E, P = dims[0], dims[2]
    state = NodeState(*(t.clone().contiguous() for t in init))
    trees["state"] = state
    chosen = torch.empty((E, P), dtype=torch.int64, device=dev)
    scores = torch.empty((E, P), dtype=dt, device=dev)
    n_yielded = torch.empty((E, P), dtype=torch.int64, device=dev)
    ptrs = [getattr(trees[tree], f).contiguous() for tree, f in DENSE_ARGS]
    # the largest limit sizes the kernel's rounds (csrc/dense_scan.cu)
    l_max = max(imax.limit, 0)
    kernels.DENSE_SCAN.launch(
        dt, ptrs + [chosen, scores, n_yielded],
        list(dims) + [int(bool(spread_alg)), l_max])
    return DenseOut(chosen, scores, n_yielded, state)


def lane_tensors(const, init, batch, *, dtype_name: str,
                 device: torch.device):
    """Stacked numpy lane tables -> (NodeConst, NodeState, PlacementBatch)
    of contiguous tensors on ``device``, each field in the dtype the
    kernel takes (floating fields in the lane dtype). A lane with no core
    asks keeps its 0-size ``ask_cores``."""
    dt = getattr(torch, dtype_name)

    def put(tree):
        vals = []
        for f in type(tree)._fields:
            a = np.ascontiguousarray(np.asarray(getattr(tree, f)))
            t = torch.from_numpy(a).to(device=device,
                                       dtype=_field_dtype(f, dt))
            vals.append(t)
        return type(tree)(*vals)

    return put(const), put(init), put(batch)


# --------------------------------------------------------------------------
# Fused transport (binpack.py _fuse_trees and solve_lane_fused's put):
# a dispatch's lane trees ship as a handful of stacked buffers, one per
# (tree, dtype, shape) group, through the resident buffer set; the
# kernels read views of them.

# tree-group name of each tree handed to _fuse_trees, by position
_FUSE_TREE_NAMES = ("const", "init", "batch", "ptab", "pinit")

# the lane fields the dense kernels read (the others ride the transport
# as the packer built them)
_DENSE_READ = frozenset(f for _, f in DENSE_ARGS)


def _fuse_trees(trees):
    """Group the trees' non-empty leaves by (tree index, dtype, shape) in
    field order. Returns (stacked buffers, per-leaf meta, group keys);
    a meta is ("zero", shape, dtype str) for a 0-size leaf or ("buf",
    group key, row). Keying by the tree index keeps the const tree's
    leaves in buffers of their own, so the content cache can keep them
    resident while the usage and batch buffers change every dispatch."""
    metas = []
    groups: dict = {}
    for ti, tree in enumerate(trees):
        for leaf in tree:
            arr = np.asarray(leaf)
            if arr.size == 0:
                metas.append(("zero", arr.shape, arr.dtype.str))
                continue
            key = (ti, arr.dtype.str, arr.shape)
            rows = groups.setdefault(key, [])
            metas.append(("buf", key, len(rows)))
            rows.append(arr)
    group_keys = tuple(groups.keys())
    stacked = [np.stack(groups[k]) for k in group_keys]
    return stacked, tuple(metas), group_keys


def fused_tensors(trees, casts, *, device: torch.device,
                  cache_version=None, delta_src=None):
    """Ship stacked numpy lane trees (NamedTuples with a leading eval
    axis; const first) to ``device`` through the resident buffer set and
    rebuild them as tensors: views of the shipped buffers, cast on the
    device where ``casts[tree index](field)`` names another dtype (None
    keeps the shipped one). Only the const tree's buffers may enter the
    content cache. Returns (rebuilt trees, bytes shipped)."""
    stacked, metas, group_keys = _fuse_trees(trees)
    buffers, shipped = resident.device_put_cached(
        stacked, device=device, version=cache_version,
        cacheable=[k[0] == 0 for k in group_keys],
        tags=[_FUSE_TREE_NAMES[k[0]] for k in group_keys],
        delta_src=delta_src)
    gpos = {k: i for i, k in enumerate(group_keys)}
    out = []
    it = iter(metas)
    for ti, tree in enumerate(trees):
        vals = []
        for f in type(tree)._fields:
            m = next(it)
            if m[0] == "zero":
                t = torch.from_numpy(np.zeros(m[1], dtype=np.dtype(m[2])))
                t = t.to(device)
            else:
                t = buffers[gpos[m[1]]][m[2]]
            want = casts[ti](f)
            if want is not None and t.dtype != want:
                t = t.to(want)
            vals.append(t)
        out.append(type(tree)(*vals))
    return tuple(out), shipped


def lane_casts(dtype_name: str):
    """The dense kernels' dtype of each lane field they read."""
    dt = getattr(torch, dtype_name)
    return lambda f: _field_dtype(f, dt) if f in _DENSE_READ else None


def solve_placements(const, init, batch, *, spread_alg: bool,
                     dtype_name=None, device: DeviceLike = None,
                     cache_version=None, delta_src=None) -> DenseOut:
    """Dense greedy solve of stacked (E, ...) numpy lane tables on
    ``device`` (default ``cuda``; no card raises): the tables ship through
    the fused transport (``cache_version`` and ``delta_src`` as in
    resident.device_put_cached), then the plain version runs on the CPU,
    the dense_scan kernel on the card. Returns DenseOut of tensors on
    that device."""
    dev = resolve_device(device)
    dtype_name = default_dtype_name(dev, dtype_name)
    cast = lane_casts(dtype_name)
    imax = index_max(const, init, batch)
    (c, s, b), _ = fused_tensors((const, init, batch), (cast,) * 3,
                                 device=dev, cache_version=cache_version,
                                 delta_src=delta_src)
    return dense_scan(c, s, b, spread_alg=spread_alg, imax=imax)


# --------------------------------------------------------------------------
# The node-sharded scan (parallel/mesh.py mesh_solve over a grid with more
# than one node cell; port of the dense program under mesh_solve_fn). A
# cell holds E_c lanes and a contiguous run of Ns nodes in window order
# (the lanes' shuffled order), starting at n0. On the card the whole scan
# of every cell of a card is one persistent launch (``dense_shard``,
# csrc/dense_shard.cu); the plain version is three phases a step, which
# read and write the same exchange area the kernel does: the cells of an
# evals row share one area (solver/exchange.py shard_views), each cell
# writing only its own slots of the step's parity, so no copies move
# between cells:
#   count  -- score the cell's nodes (fin, flags) and count its fit and
#             low nodes per lane into cnt[par, j];
#   select -- with every cell's counts (the exclusive prefix over the
#             cells before it and the totals), mark the cell's yielded
#             nodes and their window order, and write the lane's record
#             rec[par, j]: the best (score, order, node) and the number
#             yielded, with the best node's spread and distinct_property
#             value indices;
#   commit -- with every cell's record, the winner (the largest score,
#             the smallest order on ties) and n_yielded (the sum of the
#             cells' counts); the outputs; the owning cell commits usage,
#             ports, cores and devices at the node; every cell adds the
#             published value indices to its copy of the counts.
# Nothing is summed across cells but integers, so every grid gives the
# one-card scan's bits.

SHARD_COUNT, SHARD_SELECT, SHARD_COMMIT = 0, 1, 2
_NONE = 2 ** 31 - 1          # a record's order and node when none yields


def _eff_words(dt) -> int:
    return 2 if dt == torch.float64 else 1


class ShardCell:
    """One cell of the node-sharded scan: its lane tables (node-axis
    tables cut to its slice; the state a private copy it updates in
    place), its scratch, its copy of the outputs, and its row's exchange
    area: cnt (PARITIES, n_par, E_c, 2) and rec (PARITIES, n_par, E_c, W)
    int32 views shared by every cell of the row (slot j its own), with
    the sequence words the kernel publishes. ``area`` is the row's
    (exchange.shard_area_words long); without one the cell gets its own
    until ``share_area`` joins its row. ``place`` is the cell's place in
    the grid, for the kernel's error word."""

    __slots__ = ("const", "state", "batch", "j", "n_par", "n0", "dims",
                 "spread_alg", "fin", "flags", "area", "cnt", "rec", "seq",
                 "chosen", "scores", "n_yielded", "ptrs", "place")

    def __init__(self, const, init, batch, *, j: int, n_par: int,
                 spread_alg: bool, area=None, place: int = 0):
        self.const, self.batch = const, batch
        self.state = NodeState(*(t.clone().contiguous() for t in init))
        self.dims = dense_dims(const, self.state, batch)
        E, N, P = self.dims[:3]
        dt, dev = const.cpu_cap.dtype, const.cpu_cap.device
        self.j, self.n_par, self.n0 = j, n_par, j * N
        self.spread_alg = bool(spread_alg)
        self.place = int(place)
        self.fin = torch.zeros((E, N), dtype=dt, device=dev)
        self.flags = torch.zeros((E, N), dtype=torch.uint8, device=dev)
        self.chosen = torch.full((E, P), -1, dtype=torch.int64, device=dev)
        self.scores = torch.empty((E, P), dtype=dt, device=dev)
        self.n_yielded = torch.empty((E, P), dtype=torch.int64, device=dev)
        trees = {"const": const, "state": self.state, "batch": batch}
        # the kernel's pointer row, in DENSE_ARGS order then the outputs
        # and the score scratch (the area and the ints follow in ptr_row;
        # the flags are the plain phases' alone)
        self.ptrs = [getattr(trees[tree], f).contiguous()
                     for tree, f in DENSE_ARGS] + [
            self.chosen, self.scores, self.n_yielded, self.fin]
        self.bind_area(area if area is not None else exchange.zeros(
            exchange.shard_area_words(n_par, E, self.words), dev, False))

    @property
    def words(self) -> int:
        """W, the int32 words of a record."""
        S, Dp = self.dims[3], self.dims[5]
        return _eff_words(self.fin.dtype) + 3 + S + Dp

    def bind_area(self, area: torch.Tensor) -> None:
        self.area = area
        self.cnt, self.rec, self.seq = exchange.shard_views(
            area, self.n_par, self.dims[0], self.words)

    def ptr_row(self):
        """The cell's row of the kernel's device table."""
        return [t.data_ptr() for t in self.ptrs] + [
            self.area.data_ptr(), self.j, self.place]


def share_area(row) -> None:
    """Give the cells of an evals row one exchange area if they do not
    share one yet (cells built without an area): on their card, or in
    pinned host memory when they span cards."""
    if all(c.area is row[0].area for c in row):
        return
    c0 = row[0]
    devs = [c.fin.device for c in row]
    area = exchange.zeros(
        exchange.shard_area_words(c0.n_par, c0.dims[0], c0.words),
        devs[0], exchange.host_form(devs))
    for c in row:
        c.bind_area(area)


def _shard_count_plain(c: ShardCell, i: int) -> None:
    has_cores = bool(c.dims[9])
    b = _step_asks(c.batch, i, has_cores)
    b["penalty"] = b["penalty"] - c.n0      # the cell's own node numbers
    fit, final = _step_scores(c.const, c.state, b, c.spread_alg)
    low = fit & (final <= SKIP_THRESHOLD)
    c.fin.copy_(final)
    c.flags.copy_(fit.to(torch.uint8) | (low.to(torch.uint8) << 1))
    cnt = c.cnt[i % exchange.PARITIES, c.j]
    cnt[:, 0] = fit.sum(dim=1).to(torch.int32)
    cnt[:, 1] = low.sum(dim=1).to(torch.int32)


def _shard_select_plain(c: ShardCell, i: int) -> None:
    E, N, _, S, _, Dp = c.dims[:6]
    dt = c.fin.dtype
    par = i % exchange.PARITIES
    fit = (c.flags & 1).bool()
    low = (c.flags & 2).bool()
    cnt = c.cnt[par].long()
    pre = cnt[:c.j].sum(dim=0)                          # (E, 2)
    tot = cnt.sum(dim=0)
    L = c.batch.limit[:, i:i + 1].long()
    skip_rank = pre[:, 1:2] + torch.cumsum(low.long(), dim=1)
    srank = skip_rank.clamp_max(MAX_SKIP)
    skipped = low & (skip_rank <= MAX_SKIP)
    cpos = pre[:, 0:1] + torch.cumsum(fit.long(), dim=1) - srank
    window = fit & ~skipped & (cpos <= L)
    tot_counted = tot[:, 0:1] - tot[:, 1:2].clamp_max(MAX_SKIP)
    deficit = (L - torch.minimum(tot_counted, L)).clamp_min(0)
    yielded = window | (skipped & (srank <= deficit))
    order = torch.where(window, cpos, L + srank)
    neg_inf = torch.tensor(-float("inf"), dtype=dt, device=c.fin.device)
    w, best = _winner(torch.where(yielded, c.fin, neg_inf), yielded, order)
    has = yielded.any(dim=1)
    ar = torch.arange(E, device=w.device)
    none = torch.full_like(w, _NONE)
    ew = _eff_words(dt)
    rec = c.rec[par, c.j]
    rec[:, :ew] = best.contiguous().view(torch.int32).reshape(E, ew)
    rec[:, ew] = torch.where(has, order[ar, w], none).to(torch.int32)
    rec[:, ew + 1] = torch.where(has, w, none).to(torch.int32)
    rec[:, ew + 2] = yielded.sum(dim=1).to(torch.int32)
    if S:
        rec[:, ew + 3:ew + 3 + S] = torch.where(
            has[:, None], _vidx_at(c.const.spread_vidx, w), -1)
    if Dp:
        rec[:, ew + 3 + S:ew + 3 + S + Dp] = torch.where(
            has[:, None], _vidx_at(c.const.dp_vidx, w), -1)


def _shard_commit_plain(c: ShardCell, i: int) -> None:
    E, N, _, S, _, Dp = c.dims[:6]
    dt = c.fin.dtype
    ew = _eff_words(dt)
    rec = c.rec[i % exchange.PARITIES]
    eff = rec[:, :, :ew].clone(memory_format=torch.contiguous_format).view(
        dt).reshape(c.n_par, E)
    order = rec[:, :, ew].long()
    idx = rec[:, :, ew + 1].long()
    has = order != _NONE
    neg_inf = torch.tensor(-float("inf"), dtype=dt, device=eff.device)
    best = torch.where(has, eff, neg_inf).max(dim=0).values
    cand = has & (eff == best[None])
    jw = torch.where(cand, order, torch.full_like(order, _BIG)).argmin(dim=0)
    ar = torch.arange(E, device=eff.device)
    ny = rec[:, :, ew + 2].long().sum(dim=0)
    any_yield = ny > 0
    w_loc = idx[jw, ar]
    do = c.batch.active[:, i] & any_yield
    c.chosen[:, i] = torch.where(do, jw * N + w_loc, -1)
    c.scores[:, i] = torch.where(any_yield, best, neg_inf)
    c.n_yielded[:, i] = ny
    own = do & (jw == c.j)
    w_own = torch.where(own, w_loc, 0)
    b = _step_asks(c.batch, i, bool(c.dims[9]))
    _commit_usage(c.const, c.state, b, w_own, own)
    _commit_devices(c.const, c.state, w_own, own)
    pub = rec[jw, ar]                                   # (E, W)
    _commit_counts(c.state, pub[:, ew + 3:ew + 3 + S],
                   pub[:, ew + 3 + S:ew + 3 + S + Dp], do)


_SHARD_PLAIN = {SHARD_COUNT: _shard_count_plain,
                SHARD_SELECT: _shard_select_plain,
                SHARD_COMMIT: _shard_commit_plain}


@jitcheck.plain_version
def shard_steps_plain(cells) -> None:
    """The plain scan over ``cells`` on their device, in step order: each
    step's three phases on every cell, a phase on all cells before the
    next (the card runs the whole scan in one dense_shard launch). Every
    exchange group (the cells sharing an area) must be whole: a missing
    peer's slots would stay empty, where the kernel's wait would run out
    its budget, so this raises exchange.ExchangeTimeout as the kernel's
    caller would."""
    groups = {}
    for c in cells:
        groups.setdefault(id(c.area), []).append(c)
    for g in groups.values():
        have = sorted(c.j for c in g)
        if have != list(range(g[0].n_par)):
            missing = sorted(set(range(g[0].n_par)) - set(have))
            raise exchange.ExchangeTimeout(1, 0, g[0].place, -1) from \
                ValueError(f"cells {missing} of the group are not in the "
                           "launch")
    P = cells[0].chosen.shape[1]
    for step in range(P):
        for phase in (SHARD_COUNT, SHARD_SELECT, SHARD_COMMIT):
            for c in cells:
                _SHARD_PLAIN[phase](c, step)


def shard_launch(cells, err, budget_s=None):
    """(device, fn): one dense_shard launch (csrc/dense_shard.cu) that
    runs every step of every cell in ``cells`` (CUDA ShardCells on one
    card, of one dispatch), for exchange.launch. ``err`` the dispatch's
    error word, ``budget_s`` each wait's budget."""
    c0 = cells[0]
    dev = c0.fin.device
    if dev.type != "cuda":
        raise ValueError(f"dense_shard launches on a card, not {dev}")
    for c in cells:
        if c.fin.device != dev or c.dims != c0.dims or \
                c.fin.dtype != c0.fin.dtype or c.n_par != c0.n_par or \
                c.spread_alg != c0.spread_alg:
            raise ValueError("dense_shard: cells must share one device, "
                             "their lane dims, dtype, n_par and algorithm")
    table = exchange.cell_table([c.ptr_row() for c in cells], dev)
    dims = list(c0.dims) + [int(c0.spread_alg), c0.n_par, c0.words,
                            len(cells), exchange.budget_units(budget_s)]
    return dev, lambda: kernels.DENSE_SHARD.launch(
        c0.fin.dtype, [table, err], dims)


def dense_shard(cells, err=None, *, budget_s=None):
    """The node-sharded scan of ``cells`` (ShardCells on one device).
    CPU tensors: the plain phases in step order (``shard_steps_plain``;
    whole exchange groups only). CUDA tensors: one dense_shard launch on
    the card's mesh stream (``shard_launch``; any cells of a dispatch's
    grid: the rest run in other launches); ``err`` the dispatch's error
    word (a new one in the card's memory by default). Returns the error
    word: exchange.check(err) after reading the results raises if a wait
    ran out its budget."""
    dev = cells[0].fin.device
    if dev.type == "cpu":
        shard_steps_plain(cells)
        return err
    if err is None:
        err = exchange.error_word(dev, False)
    exchange.launch([shard_launch(cells, err, budget_s)],
                    hold=exchange.pinned([c.area for c in cells] + [err]))
    return err
