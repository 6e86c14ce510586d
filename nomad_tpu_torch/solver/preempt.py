"""Placement with preemption: the two preemption kernels, their plain
PyTorch versions, and the lane solves that pick between them (port of
nomad_tpu/solver/binpack.py _preempt_search_core,
_solve_placements_preempt_impl with _score_and_select_preempt, and
_solve_wave_preempt_impl with solve_lane_wave_preempt).

With preemption on, a node that fails the resource fit is still an option
when evicting some of its lower-priority allocs frees enough
(rank.go:545-565). The eviction search (preemption.go
PreemptForTaskGroup) is greedy per node: the lowest remaining priority
group first, in it the candidate with the smallest basic-resource
distance plus max_parallel penalty; then filterSuperset re-adds the picks
in descending distance to the ask and keeps the shortest covering prefix;
the fit2 recheck holds the node to its full usage after the evictions.
A preempting node scores its post-eviction binpack plus a logistic term
on the evicted set's net priority, over one more score term.

Two kernels, chosen per lane group as the reference's gate does
(service.PackedLane.wavefront_ok):

  * ``wave_preempt`` -- the windowed form: a B-slot buffer of the front
    option nodes in shuffled order, each slot carrying its (A,)
    candidate columns and an evicted mask; the search runs over (B, A)
    per step; a committed winner that is no longer an option shifts out
    one step later (the deferred zombie).
  * ``dense_preempt`` -- every step rescores all N nodes and runs the
    search over (N, A); for lanes with max_parallel penalties or windows
    too wide for the buffer.

Each has a plain PyTorch version (``*_plain``, batched over E lanes, one
Python step per placement) that the CPU tests hold against the JAX
programs and that the CUDA kernels (csrc/wave_preempt.cu,
csrc/dense_preempt.cu) are held against on the card. The wrappers take
the plain version only for a CPU tensor; a CUDA tensor launches the
kernel or raises.

Candidate resources are whole MHz and MB (the reference packs them from
allocs' comparable resources), so every sum over candidates is exact in
either dtype and the order of summation does not matter.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import jitcheck, kernels
from ..device import DeviceLike, default_dtype_name, resolve_device
from . import dense, resident
from .binpack import (
    MAX_PARALLEL_PENALTY, WPC_AFF, WPC_CAND, WPC_CC, WPC_CD, WPC_CDEV,
    WPC_CM, WPC_FEAS, WPC_NCOLS, WPC_PLACED, WPC_PLACED_JOB, WPC_POS,
    WPC_UC, WPC_UD, WPC_UM, NodeConst, NodeState, PlacementBatch,
    PreemptState, PreemptTables, _wave_p_bucket, wavefront_buffer_size,
    wavefront_preempt_compact_host)
from .scoring import (
    _BIG, _anti, _binpack_raw, _distance, _net_priority, _preempt_score,
    _score, _score_preempt, _select, _winner)

# The kernels keep a slot's or node's candidate sets as 64-bit masks.
MAX_A = 64


class SearchOut(NamedTuple):
    met: torch.Tensor        # (K,) bool: the evictions cover the ask
    evict: torch.Tensor      # (K, A) bool: the eviction set
    freed_c: torch.Tensor    # (K,) resources the eviction set frees
    freed_m: torch.Tensor
    freed_d: torch.Tensor
    net_prio: torch.Tensor   # (K,) netPriority of the eviction set


def _search_rows(used_c, used_m, used_d, prio, penalty, valid_now,
                 eligible, cpu_cap, mem_cap, disk_cap, ask_c, ask_m, ask_d,
                 static_iters: bool = False) -> SearchOut:
    """The eviction search over K rows of A candidates (a row is a node
    or a window slot): candidates (K, A); ``penalty`` the max_parallel
    penalty per candidate; caps and asks (K,). The greedy runs while some
    row is unmet and has candidates left, or ``static_iters`` a fixed A
    rounds: the body does nothing to a row once it is met or out of
    candidates, so both give the same result."""
    dt = used_c.dtype
    dev = used_c.device
    K, A = used_c.shape
    zero = torch.zeros((), dtype=dt, device=dev)
    inf = torch.tensor(float("inf"), dtype=dt, device=dev)
    ac, am, ad = ask_c[:, None], ask_m[:, None], ask_d[:, None]
    # the host Preemptor subtracts only the candidates' usage from the
    # capacity (preemption.go setCandidates); the fit2 recheck holds the
    # node to its full usage afterwards
    avail_c0 = cpu_cap - torch.where(valid_now, used_c, zero).sum(dim=1)
    avail_m0 = mem_cap - torch.where(valid_now, used_m, zero).sum(dim=1)
    avail_d0 = disk_cap - torch.where(valid_now, used_d, zero).sum(dim=1)
    ar = torch.arange(A, device=dev)
    picked = torch.zeros((K, A), dtype=torch.bool, device=dev)
    av_c, av_m, av_d = avail_c0.clone(), avail_m0.clone(), avail_d0.clone()
    ne_c = ask_c.clone()
    ne_m = ask_m.clone()
    ne_d = ask_d.clone()

    def met_now():
        # the first pick is unconditional (allMet starts False)
        return ((av_c >= ask_c) & (av_m >= ask_m) & (av_d >= ask_d)
                & picked.any(dim=1))

    for _ in range(A):
        met = met_now()
        cand = eligible & ~picked
        if not static_iters and not bool((~met & cand.any(dim=1)).any()):
            break
        # ascending priority groups (preemption.go:666): only the lowest
        # remaining priority is pickable this round
        cur = torch.where(cand, prio, torch.full_like(prio, _BIG)).min(
            dim=1).values
        in_group = cand & (prio == cur[:, None])
        dist = _distance(ne_c[:, None], ne_m[:, None], ne_d[:, None],
                         used_c, used_m, used_d) + penalty
        pick = torch.where(in_group, dist, inf).argmin(dim=1)   # first min
        do = ~met & in_group.any(dim=1)
        onehot = (ar[None, :] == pick[:, None]) & do[:, None]
        pc = torch.where(onehot, used_c, zero).sum(dim=1)
        pm = torch.where(onehot, used_m, zero).sum(dim=1)
        pd = torch.where(onehot, used_d, zero).sum(dim=1)
        picked = picked | onehot
        av_c, av_m, av_d = av_c + pc, av_m + pm, av_d + pd
        ne_c, ne_m, ne_d = ne_c - pc, ne_m - pm, ne_d - pd
    met = met_now()

    # filterSuperset (preemption.go:705): the picks in descending distance
    # to the ask (a stable sort, unpicked last), the shortest prefix that
    # covers it; argmax gives 0 when no prefix does
    d0 = _distance(ac, am, ad, used_c, used_m, used_d)
    order = torch.sort(torch.where(picked, -d0, inf), dim=1,
                       stable=True).indices
    cum_c = avail_c0[:, None] + torch.cumsum(
        torch.gather(torch.where(picked, used_c, zero), 1, order), dim=1)
    cum_m = avail_m0[:, None] + torch.cumsum(
        torch.gather(torch.where(picked, used_m, zero), 1, order), dim=1)
    cum_d = avail_d0[:, None] + torch.cumsum(
        torch.gather(torch.where(picked, used_d, zero), 1, order), dim=1)
    met_at = (cum_c >= ac) & (cum_m >= am) & (cum_d >= ad)
    first_met = met_at.to(torch.uint8).argmax(dim=1)
    keep = (ar[None, :] <= first_met[:, None]) & torch.gather(picked, 1,
                                                              order)
    evict = torch.zeros_like(picked).scatter(1, order, keep)
    return SearchOut(
        met, evict,
        torch.where(evict, used_c, zero).sum(dim=1),
        torch.where(evict, used_m, zero).sum(dim=1),
        torch.where(evict, used_d, zero).sum(dim=1),
        _net_priority(evict, prio.to(dt)))


def _maxp_penalty(maxp, n_pre, dt):
    """The max_parallel penalty of each candidate, from the evictions its
    (job, task group) already had in this eval (preemption.go
    scoreForTaskGroup)."""
    return torch.where((maxp > 0) & (n_pre >= maxp),
                       (n_pre + 1 - maxp).to(dt) * MAX_PARALLEL_PENALTY,
                       torch.zeros((), dtype=dt, device=maxp.device))


def preempt_search_plain(used_c, used_m, used_d, prio, maxp, grp,
                         valid_now, eligible, cpu_cap, mem_cap, disk_cap,
                         counts, ask_cpu, ask_mem, ask_disk, *,
                         static_iters: bool = False) -> SearchOut:
    """Plain PyTorch version of one lane's eviction search
    (_preempt_search_core) over n rows of A candidates: candidates (n,
    A), caps (n,), group counts (G,), scalar asks. ``static_iters``
    selects the fixed A-round form; both forms give the same result."""
    dt = used_c.dtype
    n = used_c.shape[0]
    n_pre = torch.where(grp >= 0, counts[grp.clamp_min(0).long()],
                        torch.zeros_like(grp))

    def full(x):
        return torch.full((n,), float(x), dtype=dt, device=used_c.device)

    return _search_rows(used_c, used_m, used_d, prio,
                        _maxp_penalty(maxp, n_pre, dt), valid_now, eligible,
                        cpu_cap, mem_cap, disk_cap, full(ask_cpu),
                        full(ask_mem), full(ask_disk),
                        static_iters=static_iters)


# --------------------------------------------------------------------------
# Dense preemption.

class DensePreemptOut(NamedTuple):
    chosen: torch.Tensor        # (E, P) int64, -1 where nothing placed
    scores: torch.Tensor        # (E, P) best yielded score, -inf if none
    n_yielded: torch.Tensor     # (E, P) int64
    evict_rows: torch.Tensor    # (E, P, A) bool: candidates each evicts
    state: NodeState            # the carried usage after the last step
    pstate: PreemptState        # evicted (E, N, A), counts (E, G)


class PreemptStep(NamedTuple):
    """One dense preemption step's per-node options, (E, N) each unless
    noted: fit (plain or preempting), the final score of fit nodes,
    which fit only through evictions, and those nodes' freed resources
    and eviction rows (E, N, A)."""
    fit: torch.Tensor
    final: torch.Tensor
    fit_p: torch.Tensor
    freed_c: torch.Tensor
    freed_m: torch.Tensor
    freed_d: torch.Tensor
    evict: torch.Tensor


def _preempt_step(const, state, b, ptab, evicted, counts, spread_alg):
    """Score one step of dense preemption (_score_and_select_preempt):
    the plain fit, and where only the resources fail, the eviction search
    (run only on those nodes; no other node's search reaches an output),
    the fit2 recheck and the preempting score. ``b`` holds the step's
    (E, 1) asks."""
    E, N, A = ptab.cpu.shape
    dt = const.cpu_cap.dtype
    dev = const.cpu_cap.device
    feas, fit, new_cpu, new_mem, new_disk, dev_score = dense._step_fit(
        const, state, b)
    se, sn = torch.nonzero(feas & ~fit, as_tuple=True)
    fit_p = torch.zeros_like(fit)
    freed_c = torch.zeros((E, N), dtype=dt, device=dev)
    freed_m = torch.zeros_like(freed_c)
    freed_d = torch.zeros_like(freed_c)
    net = torch.zeros_like(freed_c)
    evict = torch.zeros((E, N, A), dtype=torch.bool, device=dev)
    if se.numel():
        eligible_prio = (ptab.job_prio[se, None] - ptab.prio[se, sn]) >= 10
        valid_now = ptab.valid[se, sn] & ~evicted[se, sn]
        grp = ptab.grp[se, sn].long()
        n_pre = torch.where(grp >= 0,
                            counts[se[:, None], grp.clamp_min(0)],
                            torch.zeros_like(grp))
        r = _search_rows(
            ptab.cpu[se, sn], ptab.mem[se, sn], ptab.disk[se, sn],
            ptab.prio[se, sn],
            _maxp_penalty(ptab.maxp[se, sn], n_pre, dt), valid_now,
            valid_now & eligible_prio, const.cpu_cap[se, sn],
            const.mem_cap[se, sn], const.disk_cap[se, sn],
            b["ask_cpu"][se, 0], b["ask_mem"][se, 0], b["ask_disk"][se, 0])
        # fit2: the full-usage recheck after the evictions (rank.go:541)
        fit2 = ((new_cpu[se, sn] - r.freed_c <= const.cpu_cap[se, sn])
                & (new_mem[se, sn] - r.freed_m <= const.mem_cap[se, sn])
                & (new_disk[se, sn] - r.freed_d <= const.disk_cap[se, sn]))
        fit_p[se, sn] = r.met & fit2
        freed_c[se, sn] = r.freed_c
        freed_m[se, sn] = r.freed_m
        freed_d[se, sn] = r.freed_d
        net[se, sn] = r.net_prio
        evict[se, sn] = r.evict
    fit_c = fit | fit_p
    idx = torch.nonzero(fit_c, as_tuple=True)
    other, nscores = dense._step_terms(const, state, b, idx, dev_score)
    pre = fit_p[idx]
    fc = torch.where(fit_p, new_cpu - freed_c, new_cpu)
    fm = torch.where(fit_p, new_mem - freed_m, new_mem)
    bp = _binpack_raw(dense._free(fc, const.cpu_cap)[idx],
                      dense._free(fm, const.mem_cap)[idx], spread_alg)
    vals = _score(bp, other, nscores)
    if bool(pre.any()):
        vals[pre] = _score_preempt(bp[pre], other[pre],
                                   _preempt_score(net[idx][pre]),
                                   nscores[pre])
    final = torch.zeros((E, N), dtype=dt, device=dev)
    final[idx] = vals
    return PreemptStep(fit_c, final, fit_p, freed_c, freed_m, freed_d,
                       evict)


def _preempt_commit(const, state, b, ptab, evicted, counts, step, w, do,
                    any_yield):
    """Commit each lane's window winner ``w`` in place: usage less the
    freed resources where the winner preempts (whether or not the step
    is active, as the reference does), ports released, the placement
    where ``do``, the spread / distinct_property / device tables, the
    evicted mask and the group counts. Returns the step's eviction rows
    (E, A)."""
    E = w.shape[0]
    dt = const.cpu_cap.dtype
    ar = torch.arange(E, device=w.device)
    zero = torch.zeros((), dtype=dt, device=w.device)
    was_pre = any_yield & step.fit_p[ar, w]
    row = step.evict[ar, w] & (was_pre & do)[:, None]
    fr = [torch.where(was_pre, f[ar, w], zero)
          for f in (step.freed_c, step.freed_m, step.freed_d)]
    add_f = do.to(dt)
    add_i = do.to(torch.int32)
    dyn_back = torch.where(row, ptab.dyn_ports[ar, w],
                           torch.zeros_like(ptab.dyn_ports[ar, w])).sum(
                               dim=1).to(torch.int32)
    static_back = (row & ptab.static_rel[ar, w]).any(dim=1)
    state.used_cpu[ar, w] += add_f * b["ask_cpu"][:, 0] - fr[0]
    state.used_mem[ar, w] += add_f * b["ask_mem"][:, 0] - fr[1]
    state.used_disk[ar, w] += add_f * b["ask_disk"][:, 0] - fr[2]
    state.placed[ar, w] += add_i
    state.placed_job[ar, w] += add_i
    state.static_free[ar, w] = ((state.static_free[ar, w] | static_back)
                                & ~(do & b["has_static"][:, 0]))
    state.dyn_avail[ar, w] += dyn_back - add_i * b["n_dyn"][:, 0]
    dense._commit_tables(const, state, w, do)
    evicted[ar, w] |= row
    grp_w = ptab.grp[ar, w].long()                    # (E, A)
    bump = row & (grp_w >= 0)
    for a in range(grp_w.shape[1]):
        counts[ar, grp_w[:, a].clamp_min(0)] += bump[:, a].to(torch.int32)
    return row


@jitcheck.plain_version
def dense_preempt_plain(const: NodeConst, init: NodeState,
                        batch: PlacementBatch, ptab: PreemptTables,
                        pinit: PreemptState, *,
                        spread_alg: bool) -> DensePreemptOut:
    """Plain PyTorch version of dense greedy placement with eviction over
    E stacked lanes (every tensor carries a leading E axis): one Python
    step per placement. Only nodes that fail the plain fit but pass the
    rest of it run the search (no other node's search reaches an output).
    ``init`` and ``pinit`` are not modified.

    As in the reference, an inactive step whose window winner is a
    preempting node still takes the freed resources off the winner's
    usage (they are not masked by ``active``), without evicting; such
    steps come only after a lane's last placement, where they move the
    outputs of later inactive steps and the final state."""
    state = NodeState(*(t.clone() for t in init))
    evicted = pinit.evicted.clone()
    counts = pinit.counts.clone()
    E, P = batch.ask_cpu.shape
    A = ptab.cpu.shape[2]
    dt = const.cpu_cap.dtype
    dev = const.cpu_cap.device
    has_cores = const.mhz_per_core.shape[-1] > 0
    neg_inf = torch.tensor(-float("inf"), dtype=dt, device=dev)
    chosen = torch.full((E, P), -1, dtype=torch.long, device=dev)
    scores = torch.empty((E, P), dtype=dt, device=dev)
    n_yielded = torch.empty((E, P), dtype=torch.long, device=dev)
    evict_rows = torch.zeros((E, P, A), dtype=torch.bool, device=dev)
    for i in range(P):
        col = slice(i, i + 1)
        b = dense._step_asks(batch, i, has_cores)
        step = _preempt_step(const, state, b, ptab, evicted, counts,
                             spread_alg)
        _, yielded, order, ny = _select(step.final, step.fit,
                                        batch.limit[:, col].long())
        w, best = _winner(torch.where(yielded, step.final, neg_inf),
                          yielded, order)
        any_yield = ny > 0
        do = batch.active[:, i] & any_yield
        chosen[:, i] = torch.where(do, w, -1)
        scores[:, i] = torch.where(any_yield, best, neg_inf)
        n_yielded[:, i] = ny
        evict_rows[:, i] = _preempt_commit(const, state, b, ptab, evicted,
                                           counts, step, w, do, any_yield)
    return DensePreemptOut(chosen, scores, n_yielded, evict_rows, state,
                           PreemptState(evicted, counts))


# --------------------------------------------------------------------------
# Windowed preemption.

def _shift_out(cur, z, zomb, entry):
    """Shift slots >= z one left and put ``entry`` in the last slot, for
    the lanes where ``zomb`` (binpack.py _solve_wave_preempt_impl's
    shift1). ``cur`` is (E, B, ...), ``entry`` (E, ...)."""
    E, B = cur.shape[:2]
    extra = (1,) * (cur.dim() - 2)
    arangeB = torch.arange(B, device=cur.device)
    take_next = (arangeB[None, :] >= z[:, None]).reshape(E, B, *extra)
    is_last = (arangeB == B - 1).reshape(1, B, *extra)
    sh = torch.where(is_last, entry[:, None],
                     torch.where(take_next, torch.roll(cur, -1, 1), cur))
    return torch.where(zomb.reshape(E, 1, *extra), sh, cur)


@jitcheck.plain_version
def wave_preempt_plain(compact, cand, scal_f, scal_i, pen, counts0, *,
                       spread_alg: bool, B: int):
    """Plain PyTorch version of the windowed preemption scan
    (_solve_wave_preempt_impl), batched over E lanes: one Python step per
    placement. ``cand`` holds the (E, C, A) candidate tables named as
    binpack.WPC_CAND. Returns (chosen int64, scores, n_yielded int64)
    (E, P) and evict_rows (E, P, A) bool, P = C - B."""
    E, C, _ = compact.shape
    P = C - B
    A = cand["cpu"].shape[2]
    dt = compact.dtype
    dev = compact.device
    ask_c, ask_m, ask_d, count = (scal_f[:, k] for k in range(4))
    L = scal_i[:, 0:1].long()
    n_active = scal_i[:, 1].long()
    job_prio = scal_i[:, 2]
    flag = scal_i[:, 3]
    pen = pen.long()
    neg_inf = torch.tensor(-float("inf"), dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    ar = torch.arange(E, device=dev)
    rows = ar.repeat_interleave(B)          # lane of each flattened slot

    slot = compact[:, :B].clone()
    cd = {k: v[:, :B].clone() for k, v in cand.items()}
    j = torch.zeros((E, B), dtype=torch.long, device=dev)
    evicted = torch.zeros((E, B, A), dtype=torch.bool, device=dev)
    cursor = torch.full((E,), B, dtype=torch.long, device=dev)
    counts = counts0.long().clone()
    pending = torch.full((E,), -1, dtype=torch.long, device=dev)
    chosen = torch.full((E, P), -1, dtype=torch.long, device=dev)
    scores = torch.empty((E, P), dtype=dt, device=dev)
    n_yielded = torch.empty((E, P), dtype=torch.long, device=dev)
    evict_rows = torch.zeros((E, P, A), dtype=torch.bool, device=dev)

    def flat(x):
        return x.reshape(E * B, *x.shape[2:])

    for i in range(P):
        jf = j.to(dt)
        # usage now: the initial usage, the copies taken, less what the
        # slot's evictions freed
        fc_prev = torch.where(evicted, cd["cpu"], zero).sum(dim=2)
        fm_prev = torch.where(evicted, cd["mem"], zero).sum(dim=2)
        fd_prev = torch.where(evicted, cd["disk"], zero).sum(dim=2)
        new_c = (slot[..., WPC_UC] + jf * ask_c[:, None] - fc_prev
                 ) + ask_c[:, None]
        new_m = (slot[..., WPC_UM] + jf * ask_m[:, None] - fm_prev
                 ) + ask_m[:, None]
        new_d = (slot[..., WPC_UD] + jf * ask_d[:, None] - fd_prev
                 ) + ask_d[:, None]
        dcount = torch.where(flag[:, None] == 2,
                             slot[..., WPC_PLACED_JOB] + jf,
                             slot[..., WPC_PLACED] + jf)
        # device capacity countdown: a drained node is no option at all
        dev_ok = slot[..., WPC_CDEV] - jf >= 1.0
        feas = ((slot[..., WPC_FEAS] > 0.5) & dev_ok
                & ((flag[:, None] == 0) | (dcount == 0.0)))
        fit = (feas & (new_c <= slot[..., WPC_CC])
               & (new_m <= slot[..., WPC_CM]) & (new_d <= slot[..., WPC_CD]))

        valid_now = cd["valid"] & ~evicted
        eligible = valid_now & ((job_prio[:, None, None] - cd["prio"]) >= 10)
        grp = cd["grp"].long()
        n_pre = torch.where(grp >= 0,
                            counts[ar[:, None, None], grp.clamp_min(0)],
                            torch.zeros_like(grp))
        r = _search_rows(
            flat(cd["cpu"]), flat(cd["mem"]), flat(cd["disk"]),
            flat(cd["prio"]), flat(_maxp_penalty(cd["maxp"], n_pre, dt)),
            flat(valid_now), flat(eligible), flat(slot[..., WPC_CC]),
            flat(slot[..., WPC_CM]), flat(slot[..., WPC_CD]), ask_c[rows],
            ask_m[rows], ask_d[rows])
        freed_c = r.freed_c.reshape(E, B)
        freed_m = r.freed_m.reshape(E, B)
        freed_d = r.freed_d.reshape(E, B)
        evict = r.evict.reshape(E, B, A)
        fit2 = ((new_c - freed_c <= slot[..., WPC_CC])
                & (new_m - freed_m <= slot[..., WPC_CM])
                & (new_d - freed_d <= slot[..., WPC_CD]))
        fit_p = feas & ~fit & r.met.reshape(E, B) & fit2

        coll = slot[..., WPC_PLACED] + jf
        anti = _anti(coll, count[:, None])
        pen_i = pen[:, i:i + 1]
        is_pen = (pen_i >= 0) & (slot[..., WPC_POS] == pen_i.to(dt))
        resched = torch.where(is_pen, -1.0, 0.0).to(dt)
        affs = slot[..., WPC_AFF]
        nscores = (1.0 + (coll > 0).to(dt) + is_pen.to(dt)
                   + (affs != 0.0).to(dt))
        other = (anti + resched) + affs
        cc = slot[..., WPC_CC].clamp_min(1e-9)
        cm = slot[..., WPC_CM].clamp_min(1e-9)
        bp = _binpack_raw(1.0 - new_c / cc, 1.0 - new_m / cm, spread_alg)
        bp_p = _binpack_raw(1.0 - (new_c - freed_c) / cc,
                            1.0 - (new_m - freed_m) / cm, spread_alg)
        final = torch.where(
            fit_p, _score_preempt(bp_p, other, _preempt_score(
                r.net_prio.reshape(E, B)), nscores),
            _score(bp, other, nscores))
        fit_c = fit | fit_p

        _, yielded, order, ny = _select(final, fit_c, L)
        w, best = _winner(torch.where(yielded, final, neg_inf), yielded,
                          order)
        any_yield = ny > 0
        do = (i < n_active) & any_yield
        chosen[:, i] = torch.where(do, slot[ar, w, WPC_POS].long(), -1)
        scores[:, i] = torch.where(any_yield, best, neg_inf)
        n_yielded[:, i] = ny

        # commit: the winner takes one copy; a preempting winner applies
        # its eviction row and bumps its groups' counts
        was_pre = fit_p[ar, w] & do
        row = evict[ar, w] & was_pre[:, None]
        evict_rows[:, i] = row
        j[ar, w] += do.long()
        evicted[ar, w] |= row
        grp_w = grp[ar, w]
        bump = row & (grp_w >= 0)
        for a in range(A):
            counts[ar, grp_w[:, a].clamp_min(0)] += bump[:, a].long()

        # the previous winner shifts out now if it is no option any more
        # (deferred one step: this step's search already told)
        z = pending.clamp_min(0)
        zomb = (pending >= 0) & ~fit_c[ar, z]
        cur = cursor.clamp(0, C - 1)
        j = _shift_out(j, z, zomb, torch.zeros_like(cursor))
        slot = _shift_out(slot, z, zomb, compact[ar, cur])
        cd = {k: _shift_out(v, z, zomb, cand[k][ar, cur])
              for k, v in cd.items()}
        evicted = _shift_out(evicted, z, zomb,
                             torch.zeros((E, A), dtype=torch.bool,
                                         device=dev))
        cursor = cursor + zomb.long()
        w_adj = torch.where(zomb & (w > z), w - 1, w)
        pending = torch.where(do, w_adj, -1)
    return chosen, scores, n_yielded, evict_rows


# --------------------------------------------------------------------------
# Wrappers: the plain version for CPU tensors, the CUDA kernel for CUDA
# tensors, an error for anything else.

PTAB_INT = {"prio", "maxp", "grp", "dyn_ports", "job_prio"}
PTAB_BOOL = {"static_rel", "valid"}


def _ptab_dtype(name, dt):
    if name in PTAB_INT:
        return torch.int32
    if name in PTAB_BOOL:
        return torch.bool
    return dt


def _check_tensor(name, t, dtype, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")


def _check_a(A):
    if A < 1 or A > MAX_A:
        raise ValueError(f"candidate axis A={A} is outside 1..{MAX_A}, "
                         "what the preemption kernels support")


# (field, kind) order of the preemption tables nt_dense_preempt_* takes
# after dense.DENSE_ARGS (csrc/dense_preempt.cu unpacks them so)
PREEMPT_ARGS = tuple(("ptab", f) for f in PreemptTables._fields) + (
    ("pinit", "evicted"), ("pinit", "counts"))


def dense_preempt(const: NodeConst, init: NodeState, batch: PlacementBatch,
                  ptab: PreemptTables, pinit: PreemptState, *,
                  spread_alg: bool,
                  imax: dense.IndexMax = None) -> DensePreemptOut:
    """Dense greedy placement with eviction over E stacked lanes of
    tensors on one device: the plain version for CPU tensors, the
    dense_preempt kernel for CUDA tensors. ``init`` and ``pinit`` are not
    modified. ``imax``: the tables' dense.IndexMax (``grp`` included),
    taken on the host before the upload (left out, it is read from the
    tensors)."""
    dt = const.cpu_cap.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"cpu_cap dtype {dt} is not float32/float64")
    dev = const.cpu_cap.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    trees = {"const": const, "state": init, "batch": batch}
    for tree, f in dense.DENSE_ARGS:
        t = getattr(trees[tree], f)
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{tree}.{f} must be a torch.Tensor")
        if t.device != dev:
            raise ValueError(f"{tree}.{f} is on {t.device}, expected {dev}")
        if t.numel() and t.dtype != dense._field_dtype(f, dt):
            raise TypeError(f"{tree}.{f} has dtype {t.dtype}, expected "
                            f"{dense._field_dtype(f, dt)}")
    dims = dense.dense_dims(const, init, batch)
    E, N = dims[0], dims[1]
    A = ptab.cpu.shape[-1] if ptab.cpu.dim() == 3 else 0
    _check_a(A)
    G = pinit.counts.shape[-1]
    for f in PreemptTables._fields:
        shape = (E,) if f == "job_prio" else (E, N, A)
        _check_tensor(f"ptab.{f}", getattr(ptab, f), _ptab_dtype(f, dt),
                      shape, dev)
    _check_tensor("pinit.evicted", pinit.evicted, torch.bool, (E, N, A), dev)
    _check_tensor("pinit.counts", pinit.counts, torch.int32, (E, G), dev)
    if G < 1:
        raise ValueError("pinit.counts needs at least one group")
    if imax is None:
        imax = dense.index_max(const, init, batch, ptab)
    dense.check_index_max((("ptab.grp", imax.grp, G),))
    if dev.type == "cpu":
        return dense_preempt_plain(const, init, batch, ptab, pinit,
                                   spread_alg=spread_alg)
    dense.check_index_max((("spread_vidx", imax.spread_vidx, dims[4]),
                           ("dp_vidx", imax.dp_vidx, dims[6]),
                           ("penalty_idx", imax.penalty_idx, N)))
    P = dims[2]
    state = NodeState(*(t.clone().contiguous() for t in init))
    pstate = PreemptState(pinit.evicted.clone().contiguous(),
                          pinit.counts.clone().contiguous())
    trees = {"const": const, "state": state, "batch": batch, "ptab": ptab,
             "pinit": pstate}
    chosen = torch.empty((E, P), dtype=torch.int64, device=dev)
    scores = torch.empty((E, P), dtype=dt, device=dev)
    n_yielded = torch.empty((E, P), dtype=torch.int64, device=dev)
    evict_rows = torch.empty((E, P, A), dtype=torch.bool, device=dev)
    ptrs = [getattr(trees[tree], f).contiguous()
            for tree, f in dense.DENSE_ARGS + PREEMPT_ARGS]
    kernels.DENSE_PREEMPT.launch(
        dt, ptrs + [chosen, scores, n_yielded, evict_rows],
        list(dims) + [int(bool(spread_alg)), A, G])
    return DensePreemptOut(chosen, scores, n_yielded, evict_rows, state,
                           pstate)


def wave_preempt(compact, cand, scal_f, scal_i, pen, counts0, *,
                 spread_alg: bool, B: int, grp_max: int = None):
    """Windowed preemption over (E, C, WPC_NCOLS) compact tables and their
    (E, C, A) candidate tables (a dict named as binpack.WPC_CAND).
    Returns (chosen int64, scores, n_yielded int64) (E, C - B) and
    evict_rows (E, C - B, A) bool. ``grp_max``: the largest group index
    of the candidates, taken on the host before the upload (left out, it
    is read from ``cand["grp"]``)."""
    if not isinstance(compact, torch.Tensor) or compact.dim() != 3:
        raise ValueError("compact must be an (E, C, W) tensor")
    dt = compact.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"compact dtype {dt} is not float32/float64")
    dev = compact.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    E, C, W = compact.shape
    if W != WPC_NCOLS or C <= B:
        raise ValueError(f"compact shape {tuple(compact.shape)} does not "
                         f"fit B={B} with {WPC_NCOLS} columns")
    if B not in (32, 128):
        raise ValueError(f"slot buffer B={B} is not 32 or 128")
    if set(cand) != set(WPC_CAND):
        raise ValueError(f"cand must hold {WPC_CAND}")
    A = cand["cpu"].shape[-1]
    _check_a(A)
    P = C - B
    G = counts0.shape[-1]
    _check_tensor("compact", compact, dt, (E, C, W), dev)
    for k in WPC_CAND:
        kd = (dt if k in ("cpu", "mem", "disk")
              else torch.bool if k == "valid" else torch.int32)
        _check_tensor(f"cand[{k}]", cand[k], kd, (E, C, A), dev)
    _check_tensor("scal_f", scal_f, dt, (E, 4), dev)
    _check_tensor("scal_i", scal_i, torch.int32, (E, 4), dev)
    _check_tensor("pen", pen, torch.int32, (E, P), dev)
    _check_tensor("counts0", counts0, torch.int32, (E, G), dev)
    if G < 1:
        raise ValueError("counts0 needs at least one group")
    if grp_max is None:
        grp_max = dense._max_of(cand["grp"])
    dense.check_index_max((("cand[grp]", grp_max, G),))
    if dev.type == "cpu":
        return wave_preempt_plain(compact, cand, scal_f, scal_i, pen,
                                  counts0, spread_alg=spread_alg, B=B)
    return wave_preempt_launch(compact, cand, scal_f, scal_i, pen, counts0,
                               spread_alg=spread_alg, B=B)[:4]


def wave_preempt_launch(compact, cand, scal_f, scal_i, pen, counts0, *,
                        spread_alg: bool, B: int):
    """One launch of the wave_preempt kernel on inputs wave_preempt has
    checked: its outputs and the (E, G) group counts after the last step
    (the kernel bumps a copy of counts0)."""
    dt, dev = compact.dtype, compact.device
    E, C, _ = compact.shape
    A, G, P = cand["cpu"].shape[-1], counts0.shape[-1], C - B
    ins = [t.contiguous() for t in (compact, *(cand[k] for k in WPC_CAND),
                                    scal_f, scal_i, pen)]
    counts = counts0.clone().contiguous()
    chosen = torch.empty((E, P), dtype=torch.int64, device=dev)
    scores = torch.empty((E, P), dtype=dt, device=dev)
    n_yielded = torch.empty((E, P), dtype=torch.int64, device=dev)
    evict_rows = torch.empty((E, P, A), dtype=torch.bool, device=dev)
    kernels.WAVE_PREEMPT.launch(
        dt, ins + [counts, chosen, scores, n_yielded, evict_rows],
        [E, C, A, G, B, int(bool(spread_alg))])
    return chosen, scores, n_yielded, evict_rows, counts


# --------------------------------------------------------------------------
# Lane solves over stacked numpy tables.

def preempt_casts(dtype_name: str):
    """The dense preemption kernel's dtype of each field of the five
    trees (const, init, batch, ptab, pinit) that dense.fused_tensors
    ships."""
    dt = getattr(torch, dtype_name)
    lane = dense.lane_casts(dtype_name)
    pinit = {"evicted": torch.bool, "counts": torch.int32}
    return (lane, lane, lane, lambda f: _ptab_dtype(f, dt), pinit.get)


def solve_placements_preempt(const, init, batch, ptab, pinit, *,
                             spread_alg: bool, dtype_name=None,
                             device: DeviceLike = None, cache_version=None,
                             delta_src=None) -> DensePreemptOut:
    """Dense preemption solve of stacked (E, ...) numpy lane tables on
    ``device`` (default ``cuda``; no card raises), the five trees shipped
    through the fused transport (dense.fused_tensors). Returns
    DensePreemptOut of tensors on that device."""
    dev = resolve_device(device)
    dtype_name = default_dtype_name(dev, dtype_name)
    (c, s, b, pt, ps), _ = dense.fused_tensors(
        (const, init, batch, ptab, pinit), preempt_casts(dtype_name),
        device=dev, cache_version=cache_version, delta_src=delta_src)
    return dense_preempt(c, s, b, pt, ps, spread_alg=spread_alg,
                         imax=dense.index_max(const, init, batch, ptab))


class WavePreemptInputs(NamedTuple):
    """Host-side (numpy) inputs of one windowed-preemption dispatch,
    stacked over lanes."""

    compact: np.ndarray       # (E, C, WPC_NCOLS)
    cand: dict                # WPC_CAND -> (E, C, A)
    scal_f: np.ndarray        # (E, 4) ask cpu/mem/disk, count
    scal_i: np.ndarray        # (E, 4) int32 limit, n_active, job prio,
                              # distinct_hosts flag
    pen: np.ndarray           # (E, P_pad) int32
    counts0: np.ndarray       # (E, G) int32
    B: int
    P: int                    # real placement count before padding


def wave_preempt_inputs(const, init, batch, ptab, pinit, *,
                        dtype_name: str) -> WavePreemptInputs:
    """Host half of solve_lane_wave_preempt for stacked (E, ...) lane
    tables: one compact table and candidate set per lane (inert padding
    lanes share one) and the slot width B from the lanes' limit."""
    if np.asarray(const.spread_vidx).shape[1]:
        raise ValueError("the windowed preemption kernel carries no "
                         "spreads (callers gate on wavefront_ok)")
    E = np.asarray(batch.ask_cpu).shape[0]
    P = int(np.asarray(batch.ask_cpu).shape[1])
    L = int(np.asarray(batch.limit)[0][0])
    B = wavefront_buffer_size(L)
    if B is None:
        raise ValueError(f"lane limit {L} exceeds every wavefront buffer "
                         "width (caller must gate on wavefront_ok)")
    p_pad = _wave_p_bucket(P)
    active_rows = np.asarray(batch.active).any(axis=1)

    def pack_one(e):
        def row(tree):
            return type(tree)(*(np.asarray(a)[e] for a in tree))
        return wavefront_preempt_compact_host(
            row(const), row(init), row(batch), row(ptab), row(pinit),
            dtype_name, p_pad=p_pad, B=B)

    inert = None
    packs = []
    for e in range(E):
        if not active_rows[e]:
            if inert is None:
                inert = pack_one(e)
            packs.append(inert)
        else:
            packs.append(pack_one(e))
    return WavePreemptInputs(
        compact=np.stack([p[0] for p in packs]),
        cand={k: np.stack([p[1][k] for p in packs]) for k in WPC_CAND},
        scal_f=np.stack([p[2] for p in packs]),
        scal_i=np.stack([p[3] for p in packs]),
        pen=np.stack([p[4] for p in packs]),
        counts0=np.stack([p[5] for p in packs]), B=B, P=P)


def wave_preempt_tensors(inp: WavePreemptInputs, device: torch.device, *,
                         cache_version=None, delta_src=None):
    """Ship one windowed-preemption dispatch's inputs to ``device``
    through the resident buffer set, tagged ``compact_preempt`` (the
    candidate tables in sorted key order, as the reference flattens
    them): (compact, cand, scal_f, scal_i, pen, counts0) tensors."""
    keys = sorted(inp.cand)
    arrays = [inp.compact, *(inp.cand[k] for k in keys), inp.scal_f,
              inp.scal_i, inp.pen, inp.counts0]
    bufs, _ = resident.device_put_cached(
        arrays, device=device, version=cache_version,
        tags=["compact_preempt"] * len(arrays), delta_src=delta_src)
    n = len(keys)
    return (bufs[0], dict(zip(keys, bufs[1:1 + n])), *bufs[1 + n:])


def solve_lane_wave_preempt(const, init, batch, ptab, pinit, *,
                            spread_alg: bool, dtype_name: str,
                            device=None, cache_version=None,
                            delta_src=None):
    """Windowed preemption solve of a stacked lane group (leading eval
    axis): host precompute, one compact transfer, one kernel launch.
    Returns host numpy (chosen int64, scores, n_yielded int64) (E, P) and
    evict_rows (E, P, A) bool. Callers guarantee the lanes passed the
    wave gate. ``device`` may be a list of cells: when they divide the
    eval axis, each cell runs the kernel on its lanes (tables shipped
    fresh, parallel/mesh.py shard_eval_axis), else the first cell runs
    them all."""
    from .wave import eval_cells, first_cell
    inp = wave_preempt_inputs(const, init, batch, ptab, pinit,
                              dtype_name=dtype_name)
    P = inp.P
    # the group range check reads the host lanes, not the card
    grp_max = dense._max_of(inp.cand["grp"])
    cells = eval_cells(device, inp.compact.shape[0])
    if cells is None:
        dev = resolve_device(first_cell(device))
        outs = [wave_preempt(
            *wave_preempt_tensors(inp, dev, cache_version=cache_version,
                                  delta_src=delta_src),
            spread_alg=spread_alg, B=inp.B, grp_max=grp_max)]
    else:
        from ..parallel import mesh
        keys = sorted(inp.cand)
        arrays = [inp.compact, *(inp.cand[k] for k in keys), inp.scal_f,
                  inp.scal_i, inp.pen, inp.counts0]
        per_cell, _ = mesh.shard_eval_axis(arrays, cells,
                                           tag="compact_preempt")
        n = len(keys)
        outs = [wave_preempt(b[0], dict(zip(keys, b[1:1 + n])),
                             *b[1 + n:], spread_alg=spread_alg, B=inp.B,
                             grp_max=grp_max)
                for b in per_cell]
    # the dispatch's one read-back (the reference's wave_preempt
    # device_get)
    with jitcheck.sanctioned_fetch("wave_preempt"):
        chosen, scores, n_yielded, evict_rows = tuple(
            np.concatenate([o[k][:, :P].cpu().numpy() for o in outs])
            for k in range(4))
    return chosen, scores, n_yielded, evict_rows
