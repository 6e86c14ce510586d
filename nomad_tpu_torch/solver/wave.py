"""Wavefront placement: the two wave kernels, their plain PyTorch versions,
and the lane solve that picks between them (port of the wave section of
nomad_tpu/solver/binpack.py). solve_lane_fused sends every other lane
group to the dense scan (solver/dense.py), and preemption groups to the
preemption kernels (solver/preempt.py).

Every placement of a wave lane is the same task-group ask, so a node's
score after j of its own placements is a closed form of j. The selection
window (select.go LimitIterator + MaxScoreIterator) only ever looks at the
first limit + MAX_SKIP fit nodes in shuffled order, so a step carries a
B-slot buffer of those front nodes: per-slot copies taken j plus the
compact-table row (c, used_cpu, used_mem, cpu_cap, mem_cap, placed,
affinity, pos, spread value indexes). The winner's j grows; a slot that
reaches its capacity c shifts out and the next fit row refills the buffer.

Two kernels, chosen per lane group exactly as the reference does:

  * ``wave_compact`` -- one placement per step. Carries spread counts and
    applies the per-placement reschedule penalty.
  * ``wave_block`` -- lanes with no spreads and no penalties. While one
    slot keeps winning every other slot's head score is frozen, so one
    step commits the winner's whole run (up to WAVE_K picks) in closed
    form; refills happen only on saturation.

Each has a plain PyTorch version (``*_plain``, batched over lanes) that
the CPU tests hold against the JAX programs and that the CUDA kernels are
held against on the card. The wrappers take the plain version only for a
CPU tensor; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import kernels
from ..device import DeviceLike, resolve_device
from . import dense, preempt
from .binpack import (
    SKIP_THRESHOLD, WAVE_K, WaveSpread, _wave_p_bucket,
    wavefront_buffer_size, wavefront_compact_host)
from .scoring import (
    _anti, _binpack_raw, _score, _select, _spread_boost, _winner, _BIG)


def _slot_scores(slot, j, ask_cpu, ask_mem, count, spread_alg):
    """Per-slot head terms shared by both kernels: fit, clipped binpack
    fitness, collision count, anti-affinity, affinity. (E, B) each."""
    dt = slot.dtype
    fit = j.to(dt) < slot[..., 0]          # sentinel rows: c = 0
    jp1 = (j + 1).to(dt)
    new_cpu = slot[..., 1] + jp1 * ask_cpu
    new_mem = slot[..., 2] + jp1 * ask_mem
    free_cpu = 1.0 - new_cpu / slot[..., 3].clamp_min(1e-9)
    free_mem = 1.0 - new_mem / slot[..., 4].clamp_min(1e-9)
    binpack = _binpack_raw(free_cpu, free_mem, spread_alg)
    coll = slot[..., 5] + j.to(dt)
    return fit, binpack, coll, _anti(coll, count), slot[..., 6]


def _refill_shift(compact, cursor, w, j, slot, gate):
    """Shift slots above ``w`` left, append the ``cursor`` row of
    ``compact``, advance the cursor -- all gated per lane on ``gate``."""
    E, C, _ = compact.shape
    B = slot.shape[1]
    ar = torch.arange(E, device=compact.device)
    row = compact[ar, cursor.clamp_max(C - 1)]
    arangeB = torch.arange(B, device=compact.device)
    take_next = arangeB[None, :] >= w[:, None]
    is_last = (arangeB == B - 1)[None, :].expand(E, B)
    j_sh = torch.where(is_last, torch.zeros_like(j),
                       torch.where(take_next, torch.roll(j, -1, 1), j))
    slot_sh = torch.where(
        is_last[..., None], row[:, None, :].expand_as(slot),
        torch.where(take_next[..., None], torch.roll(slot, -1, 1), slot))
    j = torch.where(gate[:, None], j_sh, j)
    slot = torch.where(gate[:, None, None], slot_sh, slot)
    return j, slot, cursor + gate.long()


def _spread_total(slot, counts, sp, wfrac):
    """(E, B) sum over spreads of each slot's spread boost (spread.go
    SpreadIterator + evenSpreadScoreBoost), summed in spread order."""
    total = torch.zeros(slot.shape[:2], dtype=slot.dtype, device=slot.device)
    for s in range(counts.shape[1]):
        total = total + _spread_boost(
            slot[..., 8 + s].long(), counts[:, s], sp.desired[:, s],
            sp.has_targets[:, s:s + 1], wfrac[:, s:s + 1])
    return total


def wave_compact_plain(compact, scal_f, scal_i, pen, sp: WaveSpread, *,
                       spread_alg: bool, B: int):
    """Plain PyTorch version of the per-placement wavefront
    (_solve_wave_compact_impl), batched over E lanes: one Python step per
    placement. Returns (chosen int64, scores, n_yielded int64), (E, P)."""
    E, C, _ = compact.shape
    P = C - B
    dt = compact.dtype
    dev = compact.device
    ask_cpu = scal_f[:, 0:1]
    ask_mem = scal_f[:, 1:2]
    count = scal_f[:, 2:3]
    L = scal_i[:, 0:1].long()
    n_active = scal_i[:, 1].long()
    pen = pen.long()
    S = sp.counts.shape[1]
    counts = sp.counts.long().clone()
    wfrac = sp.weights / sp.sum_weights.clamp_min(1e-9)[:, None]
    ar = torch.arange(E, device=dev)
    neg_inf = torch.tensor(-float("inf"), dtype=dt, device=dev)

    slot = compact[:, :B].clone()
    j = torch.zeros((E, B), dtype=torch.long, device=dev)
    cursor = torch.full((E,), B, dtype=torch.long, device=dev)
    chosen = torch.full((E, P), -1, dtype=torch.long, device=dev)
    scores = torch.empty((E, P), dtype=dt, device=dev)
    n_yielded = torch.empty((E, P), dtype=torch.long, device=dev)
    for i in range(P):
        pen_i = pen[:, i:i + 1]
        fit, binpack, coll, anti, affs = _slot_scores(
            slot, j, ask_cpu, ask_mem, count, spread_alg)
        # per-placement reschedule penalty via the pos column (exact ints)
        is_pen = (pen_i >= 0) & (slot[..., 7] == pen_i.to(dt))
        resched = torch.where(is_pen, -1.0, 0.0).to(dt)
        spread_total = (_spread_total(slot, counts, sp, wfrac) if S
                        else torch.zeros_like(affs))
        nscores = (1.0 + (coll > 0).to(dt) + is_pen.to(dt)
                   + (affs != 0.0).to(dt) + (spread_total != 0.0).to(dt))
        final = _score(binpack, ((anti + resched) + affs) + spread_total,
                       nscores)
        _, yielded, order, ny = _select(final, fit, L)
        eff = torch.where(yielded, final, neg_inf)
        w, best = _winner(eff, yielded, order)
        any_yield = ny > 0
        do = (i < n_active) & any_yield
        pos_w = slot[ar, w, 7]
        chosen[:, i] = torch.where(do, pos_w.long(), -1)
        scores[:, i] = torch.where(any_yield, best, neg_inf)
        n_yielded[:, i] = ny
        if not bool(do.any()) and not bool((pen[:, i + 1:] >= 0).any()):
            # every lane is frozen and no penalty is left to move a score:
            # later steps repeat this one
            chosen[:, i:] = -1
            scores[:, i:] = scores[:, i:i + 1]
            n_yielded[:, i:] = n_yielded[:, i:i + 1]
            break
        j[ar, w] += do.long()
        sat = do & (j[ar, w].to(dt) >= slot[ar, w, 0])
        if S:
            # winner's value index per spread -> bump its count
            vw = slot[ar, w, 8:].long()                   # (E, S)
            bump = do[:, None] & (vw >= 0)
            for s in range(S):
                counts[ar, s, vw[:, s].clamp_min(0)] += bump[:, s].long()
        j, slot, cursor = _refill_shift(compact, cursor, w, j, slot, sat)
    return chosen, scores, n_yielded


def _block_head(slot, j, ask_cpu, ask_mem, count, L, spread_alg):
    """The per-placement step's head computation at (j, slot) for lanes
    without spreads or penalties: (f0, low, yielded, order, ny)."""
    dt = slot.dtype
    fit, binpack, coll, anti, affs = _slot_scores(
        slot, j, ask_cpu, ask_mem, count, spread_alg)
    nsc = 1.0 + (coll > 0).to(dt) + (affs != 0.0).to(dt)
    f0 = _score(binpack, anti + affs, nsc)
    low, yielded, order, ny = _select(f0, fit, L)
    return f0, low, yielded, order, ny


def wave_block_plain(compact, scal_f, scal_i, *, spread_alg: bool, B: int,
                     K: int = WAVE_K):
    """Plain PyTorch version of the run-block wavefront
    (_solve_wave_block_impl), batched over E lanes. Each pass commits
    every live lane's winner run: picks until the winner's stream value
    loses to the frozen runner-up, crosses the skip threshold, saturates
    (then shift/refill), or the lane's placements run out. Outputs are
    identical for every K >= 1 and to wave_compact_plain on such lanes."""
    E, C, _ = compact.shape
    P = C - B
    dt = compact.dtype
    dev = compact.device
    ask_cpu = scal_f[:, 0:1]
    ask_mem = scal_f[:, 1:2]
    count = scal_f[:, 2:3]
    L = scal_i[:, 0:1].long()
    n_active = scal_i[:, 1].long()
    ar = torch.arange(E, device=dev)
    q = torch.arange(K, device=dev)[None, :]
    qf = q.to(dt)
    neg_inf = torch.tensor(-float("inf"), dtype=dt, device=dev)

    slot = compact[:, :B].clone()
    j = torch.zeros((E, B), dtype=torch.long, device=dev)
    cursor = torch.full((E,), B, dtype=torch.long, device=dev)
    p = torch.zeros(E, dtype=torch.long, device=dev)
    done = torch.zeros(E, dtype=torch.bool, device=dev)
    ch = torch.full((E, P + K), -1, dtype=torch.long, device=dev)
    sc = torch.full((E, P + K), -float("inf"), dtype=dt, device=dev)
    nyb = torch.zeros((E, P + K), dtype=torch.long, device=dev)
    while True:
        live = (p < n_active) & ~done
        if not bool(live.any()):
            break
        f0, low, yielded, order, ny = _block_head(
            slot, j, ask_cpu, ask_mem, count, L, spread_alg)
        any_yield = ny > 0
        effH = torch.where(yielded, f0, neg_inf)
        w, _ = _winner(effH, yielded, order)
        # frozen runner-up: best other head, ties to its earliest order
        eff_o = effH.clone()
        eff_o[ar, w] = neg_inf
        rub = eff_o.max(dim=1, keepdim=True).values
        rub_ord = torch.where(eff_o == rub, order,
                              torch.full_like(order, _BIG)).min(
                                  dim=1, keepdim=True).values
        ws = slot[ar, w]                                   # (E, W)
        cs_w, ucpu_w, umem_w = ws[:, 0:1], ws[:, 1:2], ws[:, 2:3]
        ccap_w, mcap_w, placed_w = ws[:, 3:4], ws[:, 4:5], ws[:, 5:6]
        aff_w, pos_w = ws[:, 6:7], ws[:, 7]
        j_wf = j[ar, w].to(dt)[:, None]
        order_wf = order[ar, w].to(dt)[:, None]
        low_w = low[ar, w][:, None]

        # the winner's forward stream: vals[q] = score of its
        # (j_w + q + 1)-th placement, the head expressions over q
        jq = j_wf + qf
        validw = jq < cs_w
        jp1q = jq + 1.0
        fcq = 1.0 - (ucpu_w + jp1q * ask_cpu) / ccap_w.clamp_min(1e-9)
        fmq = 1.0 - (umem_w + jp1q * ask_mem) / mcap_w.clamp_min(1e-9)
        bpq = _binpack_raw(fcq, fmq, spread_alg)
        collq = placed_w + jq
        nscq = (1.0 + (collq > 0).to(dt)
                + torch.where(aff_w != 0.0, 1.0, 0.0).to(dt))
        vals = _score(bpq, _anti(collq, count) + aff_w, nscq)

        win_q = ((vals > rub) | ((vals == rub) & (order_wf < rub_ord.to(dt)))
                 | (q == 0))
        cross = torch.where(low_w, vals > SKIP_THRESHOLD,
                            vals <= SKIP_THRESHOLD) & (q > 0)
        stop_q = (~validw) | (~win_q) | cross | (q >= (n_active - p)[:, None])
        tlim = torch.where(stop_q, q, K).min(dim=1).values
        q_sat = (cs_w[:, 0] - 1.0 - j_wf[:, 0]).long()
        has_sat = (q_sat < K) & (q_sat < tlim)
        t = torch.where(has_sat, q_sat + 1, tlim)
        active = any_yield & live
        t = torch.where(active, t, 0)
        has_sat = has_sat & active

        # emit the run: positions p .. p+t-1
        emit = q < t[:, None]
        idx = torch.where(emit, p[:, None] + q, P + K - 1)
        rows = ar[:, None].expand_as(idx)
        ch[rows[emit], idx[emit]] = pos_w.long()[:, None].expand_as(
            idx)[emit]
        sc[rows[emit], idx[emit]] = vals[emit]
        nyb[rows[emit], idx[emit]] = ny[:, None].expand_as(idx)[emit]

        j[ar, w] += t
        j, slot, cursor = _refill_shift(compact, cursor, w, j, slot,
                                        has_sat)
        done = done | (live & ~any_yield)
        p = p + t

    # past the last run: the per-placement scan keeps emitting (-1, best
    # head score, n_yielded) from its frozen state
    f0, _, yielded, _, ny_f = _block_head(
        slot, j, ask_cpu, ask_mem, count, L, spread_alg)
    best_f = torch.where(yielded, f0, neg_inf).max(dim=1).values
    fill = torch.arange(P + K, device=dev)[None, :] >= p[:, None]
    sc_fill = torch.where(ny_f > 0, best_f, neg_inf)[:, None]
    ch = torch.where(fill, -1, ch)
    sc = torch.where(fill, sc_fill, sc)
    nyb = torch.where(fill, ny_f[:, None], nyb)
    return ch[:, :P], sc[:, :P], nyb[:, :P]


# --------------------------------------------------------------------------
# Wrappers: the plain version for CPU tensors, the CUDA kernel for CUDA
# tensors, an error for anything else.

def _check(name, t, dtype, ndim, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_common(compact, scal_f, scal_i, B):
    if not isinstance(compact, torch.Tensor) or compact.dim() != 3:
        raise ValueError("compact must be an (E, C, W) tensor")
    dt = compact.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"compact dtype {dt} is not float32/float64")
    dev = compact.device
    _check("compact", compact, dt, 3, dev)
    E, C, W = compact.shape
    if W < 8 or C <= B:
        raise ValueError(f"compact shape {tuple(compact.shape)} does not "
                         f"fit B={B}")
    _check("scal_f", scal_f, dt, 2, dev)
    _check("scal_i", scal_i, torch.int32, 2, dev)
    if scal_f.shape != (E, 3) or scal_i.shape != (E, 2):
        raise ValueError("scal_f must be (E, 3) and scal_i (E, 2)")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return E, C, W, dt, dev


def wave_compact(compact, scal_f, scal_i, pen, sp: WaveSpread, *,
                 spread_alg: bool, B: int):
    """Per-placement wavefront over (E, C, 8+S) compact tables.
    Returns (chosen int64, scores, n_yielded int64), each (E, C - B)."""
    E, C, W, dt, dev = _check_common(compact, scal_f, scal_i, B)
    P = C - B
    S = W - 8
    _check("pen", pen, torch.int32, 2, dev)
    if pen.shape != (E, P):
        raise ValueError(f"pen must be ({E}, {P})")
    _check("sp.counts", sp.counts, torch.int32, 3, dev)
    V = sp.counts.shape[2]
    _check("sp.desired", sp.desired, dt, 3, dev)
    _check("sp.has_targets", sp.has_targets, torch.bool, 2, dev)
    _check("sp.weights", sp.weights, dt, 2, dev)
    _check("sp.sum_weights", sp.sum_weights, dt, 1, dev)
    if (sp.counts.shape[:2] != (E, S) or sp.desired.shape != (E, S, V)
            or sp.has_targets.shape != (E, S) or sp.weights.shape != (E, S)
            or sp.sum_weights.shape != (E,)):
        raise ValueError("spread tables do not match the compact table's "
                         f"E={E}, S={S}")
    if dev.type == "cpu":
        return wave_compact_plain(compact, scal_f, scal_i, pen, sp,
                                  spread_alg=spread_alg, B=B)
    chosen = torch.empty((E, P), dtype=torch.int64, device=dev)
    scores = torch.empty((E, P), dtype=dt, device=dev)
    n_yielded = torch.empty((E, P), dtype=torch.int64, device=dev)
    kernels.WAVE_COMPACT.launch(
        dt, [compact, scal_f, scal_i, pen, sp.counts, sp.desired,
             sp.has_targets, sp.weights, sp.sum_weights, chosen, scores,
             n_yielded],
        [E, C, W, S, V, B, int(bool(spread_alg))])
    return chosen, scores, n_yielded


def wave_block(compact, scal_f, scal_i, *, spread_alg: bool, B: int):
    """Run-block wavefront over (E, C, W >= 8) compact tables of lanes with
    no spreads and no penalties. Returns (chosen int64, scores,
    n_yielded int64), each (E, C - B)."""
    E, C, W, dt, dev = _check_common(compact, scal_f, scal_i, B)
    P = C - B
    if dev.type == "cpu":
        return wave_block_plain(compact, scal_f, scal_i,
                                spread_alg=spread_alg, B=B)
    chosen = torch.empty((E, P), dtype=torch.int64, device=dev)
    scores = torch.empty((E, P), dtype=dt, device=dev)
    n_yielded = torch.empty((E, P), dtype=torch.int64, device=dev)
    kernels.WAVE_BLOCK.launch(
        dt, [compact, scal_f, scal_i, chosen, scores, n_yielded],
        [E, C, W, B, int(bool(spread_alg))])
    return chosen, scores, n_yielded


# --------------------------------------------------------------------------
# Lane solve.

class WaveInputs(NamedTuple):
    """Host-side (numpy) inputs of one wave dispatch, stacked over lanes."""

    compact: np.ndarray       # (E, C, 8+S)
    scal_f: np.ndarray        # (E, 3) ask_cpu, ask_mem, count
    scal_i: np.ndarray        # (E, 2) int32 limit, n_active
    pen: np.ndarray           # (E, P_pad) int32
    sp: WaveSpread            # stacked (E, ...) spread tables
    B: int
    use_block: bool           # no spreads and no active penalties
    P: int                    # real placement count before padding


def wave_inputs(const, init, batch, *, dtype_name: str) -> WaveInputs:
    """Host half of solve_lane_wave for stacked (E, ...) lane tables: one
    compact table per lane, the slot width B from the lanes' limit, and
    the kernel gate (block when S == 0 and no penalty is active)."""
    E = np.asarray(batch.ask_cpu).shape[0]
    P = int(np.asarray(batch.ask_cpu).shape[1])
    L = int(np.asarray(batch.limit)[0][0])
    B = wavefront_buffer_size(L)
    if B is None:
        raise ValueError(f"lane limit {L} exceeds every wavefront buffer "
                         "width (caller must gate on wavefront_ok)")
    p_pad = _wave_p_bucket(P)
    # inert padding lanes (active all False) share one precompute
    active_rows = np.asarray(batch.active).any(axis=1)

    def pack_one(e):
        def row(tree):
            return type(tree)(*(np.asarray(a)[e] for a in tree))
        return wavefront_compact_host(row(const), row(init), row(batch),
                                      dtype_name, p_pad=p_pad, B=B)

    inert_pack = None
    packs = []
    for e in range(E):
        if not active_rows[e]:
            if inert_pack is None:
                inert_pack = pack_one(e)
            packs.append(inert_pack)
        else:
            packs.append(pack_one(e))
    pen = np.stack([pk[3] for pk in packs])
    sp = WaveSpread(*(np.stack(xs) for xs in zip(*[pk[4] for pk in packs])))
    use_block = sp.counts.shape[1] == 0 and bool((pen < 0).all())
    return WaveInputs(
        compact=np.stack([pk[0] for pk in packs]),
        scal_f=np.stack([pk[1] for pk in packs]),
        scal_i=np.stack([pk[2] for pk in packs]),
        pen=pen, sp=sp, B=B, use_block=use_block, P=P)


def wave_tensors(inp: WaveInputs, device: torch.device):
    """Ship one stacked wave dispatch's inputs to ``device``: (compact,
    scal_f, scal_i, pen, WaveSpread) tensors."""
    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return (put(inp.compact), put(inp.scal_f), put(inp.scal_i),
            put(inp.pen), WaveSpread(*(put(a) for a in inp.sp)))


def run_wave(inp: WaveInputs, *, spread_alg: bool, device: torch.device):
    """Run the kernel the gate chose on ``device``. Returns device tensors
    (chosen, scores, n_yielded), each (E, P_pad)."""
    compact, scal_f, scal_i, pen, sp = wave_tensors(inp, device)
    if inp.use_block:
        return wave_block(compact, scal_f, scal_i, spread_alg=spread_alg,
                          B=inp.B)
    return wave_compact(compact, scal_f, scal_i, pen, sp,
                        spread_alg=spread_alg, B=inp.B)


def solve_lane_wave(const, init, batch, *, spread_alg: bool,
                    dtype_name: str, device: DeviceLike = None):
    """Wavefront solve of a stacked lane group (leading eval axis) with
    host precompute + one compact transfer; returns host numpy (chosen
    int64, scores, n_yielded int64), each (E, P). Callers guarantee the
    lanes passed the wave gate."""
    dev = resolve_device(device)
    inp = wave_inputs(const, init, batch, dtype_name=dtype_name)
    chosen, scores, n_yielded = run_wave(inp, spread_alg=spread_alg,
                                         device=dev)
    P = inp.P
    return (chosen[:, :P].cpu().numpy(), scores[:, :P].cpu().numpy(),
            n_yielded[:, :P].cpu().numpy())


def solve_lane_fused(const, init, batch, ptab=None, pinit=None, *,
                     spread_alg: bool, dtype_name: str, wave: bool = False,
                     device: DeviceLike = None):
    """Solve a stacked lane group; returns host numpy (chosen int64,
    scores, n_yielded int64), each (E, P), plus evict_rows (E, P, A) bool
    for a preemption group (``ptab``/``pinit`` stacked). ``wave`` routes
    through the wavefront kernels (the caller checked the gate), anything
    else through the dense greedy scan (solver/dense.py); a preemption
    group through the windowed or the dense preemption kernel
    (solver/preempt.py)."""
    if ptab is not None:
        if wave:
            return preempt.solve_lane_wave_preempt(
                const, init, batch, ptab, pinit, spread_alg=spread_alg,
                dtype_name=dtype_name, device=device)
        out = preempt.solve_placements_preempt(
            const, init, batch, ptab, pinit, spread_alg=spread_alg,
            dtype_name=dtype_name, device=device)
        return (out.chosen.cpu().numpy(), out.scores.cpu().numpy(),
                out.n_yielded.cpu().numpy(), out.evict_rows.cpu().numpy())
    if wave:
        return solve_lane_wave(const, init, batch, spread_alg=spread_alg,
                               dtype_name=dtype_name, device=device)
    out = dense.solve_placements(const, init, batch, spread_alg=spread_alg,
                                 dtype_name=dtype_name, device=device)
    return (out.chosen.cpu().numpy(), out.scores.cpu().numpy(),
            out.n_yielded.cpu().numpy())
