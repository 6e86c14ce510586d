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

from .. import jitcheck, kernels
from ..device import DeviceLike, default_dtype_name, resolve_device
from . import dense, preempt, resident, xferobs
from .binpack import (
    SKIP_THRESHOLD, WAVE_B, WAVE_K, NodeConst, NodeState, PlacementBatch,
    WaveSpread, _wave_p_bucket, wavefront_buffer_size,
    wavefront_compact_host)
from .scoring import (
    _anti, _binpack_raw, _fma, _score, _select, _spread_boost, _winner,
    _BIG)


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


@jitcheck.plain_version
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


@jitcheck.plain_version
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


def wave_tensors(inp: WaveInputs, device: torch.device, *,
                 cache_version=None, delta_src=None):
    """Ship one stacked wave dispatch's inputs to ``device`` through the
    resident buffer set, tagged ``compact``: (compact, scal_f, scal_i,
    pen, WaveSpread) tensors."""
    arrays = [inp.compact, inp.scal_f, inp.scal_i, inp.pen, *inp.sp]
    bufs, _ = resident.device_put_cached(
        arrays, device=device, version=cache_version,
        tags=["compact"] * len(arrays), delta_src=delta_src)
    return (*bufs[:4], WaveSpread(*bufs[4:]))


def _wave_kernel(inp: WaveInputs, compact, scal_f, scal_i, pen, sp, *,
                 spread_alg: bool):
    if inp.use_block:
        return wave_block(compact, scal_f, scal_i, spread_alg=spread_alg,
                          B=inp.B)
    return wave_compact(compact, scal_f, scal_i, pen, sp,
                        spread_alg=spread_alg, B=inp.B)


def run_wave(inp: WaveInputs, *, spread_alg: bool, device: torch.device,
             cache_version=None, delta_src=None):
    """Run the kernel the gate chose on ``device``. Returns device tensors
    (chosen, scores, n_yielded), each (E, P_pad)."""
    compact, scal_f, scal_i, pen, sp = wave_tensors(
        inp, device, cache_version=cache_version, delta_src=delta_src)
    return _wave_kernel(inp, compact, scal_f, scal_i, pen, sp,
                        spread_alg=spread_alg)


def eval_cells(device, e_dim: int):
    """The cells an eval-sharded dispatch splits over (the reference's
    _put_eval_sharded gate): ``device`` a list of more than one cell that
    divides the fused eval axis, with the mesh switched on; else None,
    and the dispatch runs on one device."""
    if not isinstance(device, (list, tuple)) or len(device) < 2:
        return None
    from ..parallel import mesh
    if not mesh.mesh_enabled() or e_dim % len(device):
        return None
    return [resolve_device(d) for d in device]


def first_cell(device):
    """One device: ``device`` itself, or the first of a list of cells."""
    return device[0] if isinstance(device, (list, tuple)) else device


def solve_lane_wave(const, init, batch, *, spread_alg: bool,
                    dtype_name: str, device=None,
                    cache_version=None, delta_src=None):
    """Wavefront solve of a stacked lane group (leading eval axis) with
    host precompute + one compact transfer; returns host numpy (chosen
    int64, scores, n_yielded int64), each (E, P). Callers guarantee the
    lanes passed the wave gate. ``device`` may be a list of cells: when
    they divide the eval axis, each cell runs the kernel on its lanes
    (tables shipped fresh, parallel/mesh.py shard_eval_axis), else the
    first cell runs them all."""
    inp = wave_inputs(const, init, batch, dtype_name=dtype_name)
    P = inp.P
    cells = eval_cells(device, inp.compact.shape[0])
    if cells is None:
        dev = resolve_device(first_cell(device))
        chosen, scores, n_yielded = run_wave(
            inp, spread_alg=spread_alg, device=dev,
            cache_version=cache_version, delta_src=delta_src)
        # the dispatch's one read-back (the reference's wave device_get)
        with jitcheck.sanctioned_fetch("wave"):
            return (chosen[:, :P].cpu().numpy(),
                    scores[:, :P].cpu().numpy(),
                    n_yielded[:, :P].cpu().numpy())
    from ..parallel import mesh
    arrays = [inp.compact, inp.scal_f, inp.scal_i, inp.pen, *inp.sp]
    per_cell, _ = mesh.shard_eval_axis(arrays, cells, tag="compact")
    outs = [_wave_kernel(inp, *b[:4], WaveSpread(*b[4:]),
                         spread_alg=spread_alg) for b in per_cell]
    with jitcheck.sanctioned_fetch("wave"):
        return tuple(np.concatenate([o[k][:, :P].cpu().numpy()
                                     for o in outs]) for k in range(3))


def solve_lane_fused(const, init, batch, ptab=None, pinit=None, *,
                     spread_alg: bool, dtype_name: str, wave: bool = False,
                     device=None, cache_version=None, delta_src=None):
    """Solve a stacked lane group; returns host numpy (chosen int64,
    scores, n_yielded int64), each (E, P), plus evict_rows (E, P, A) bool
    for a preemption group (``ptab``/``pinit`` stacked). ``wave`` routes
    through the wavefront kernels (the caller checked the gate), anything
    else through the dense greedy scan (solver/dense.py); a preemption
    group through the windowed or the dense preemption kernel
    (solver/preempt.py). Every one-device route ships its tables through
    the resident buffer set (solver/resident.py): ``cache_version`` is
    the packing snapshot's node-table index, ``delta_src`` its (store,
    index) pair for the version chain. ``device`` may be a list of cells:
    the wave routes split their eval axis over them (solve_lane_wave),
    the dense routes run on the first."""
    kw = dict(spread_alg=spread_alg, dtype_name=dtype_name, device=device,
              cache_version=cache_version, delta_src=delta_src)
    if ptab is not None:
        if wave:
            return _fetched(preempt.solve_lane_wave_preempt(
                const, init, batch, ptab, pinit, **kw), "wave_preempt")
        kw["device"] = first_cell(device)
        out = preempt.solve_placements_preempt(
            const, init, batch, ptab, pinit, **kw)
        # the dispatch's one read-back (the reference's fused_preempt
        # device_get)
        with jitcheck.sanctioned_fetch("fused_preempt"):
            host = (out.chosen.cpu().numpy(), out.scores.cpu().numpy(),
                    out.n_yielded.cpu().numpy(),
                    out.evict_rows.cpu().numpy())
        return _fetched(host, "fused_preempt")
    if wave:
        return _fetched(solve_lane_wave(const, init, batch, **kw), "wave")
    kw["device"] = first_cell(device)
    out = dense.solve_placements(const, init, batch, **kw)
    # the dispatch's one read-back (the reference's fused device_get)
    with jitcheck.sanctioned_fetch("fused"):
        host = (out.chosen.cpu().numpy(), out.scores.cpu().numpy(),
                out.n_yielded.cpu().numpy())
    return _fetched(host, "fused")


def _fetched(out: tuple, tag: str) -> tuple:
    """Count a route's read-back in the transfer ledger under ``tag``."""
    xferobs.note_fetch(xferobs.tree_nbytes(out), tag)
    return out


# --------------------------------------------------------------------------
# The in-kernel wavefront (binpack.py _solve_wavefront_impl): capacities,
# fit order and compact table computed on the device from the dense lane
# tables, then the wave step with no spread columns, B = WAVE_B. On the
# card a penalty-free lane takes the run-block loop and any other the
# per-placement loop (csrc/wavefront.cu); both give the per-placement
# step's outputs, which the plain version computes.

# (tree, field) order of the tensor pointers nt_wavefront_* takes
# (csrc/wavefront.cu unpacks them in this order)
WAVEFRONT_ARGS = (
    ("const", "cpu_cap"), ("const", "mem_cap"), ("const", "disk_cap"),
    ("const", "feasible"), ("const", "affinity"), ("const", "has_affinity"),
    ("const", "distinct_hosts"), ("const", "distinct_job_level"),
    ("state", "used_cpu"), ("state", "used_mem"), ("state", "used_disk"),
    ("state", "placed"), ("state", "placed_job"), ("state", "static_free"),
    ("state", "dyn_avail"),
    ("batch", "ask_cpu"), ("batch", "ask_mem"), ("batch", "ask_disk"),
    ("batch", "n_dyn_ports"), ("batch", "has_static"), ("batch", "limit"),
    ("batch", "count"), ("batch", "active"), ("batch", "penalty_idx"),
)

_I32_MIN, _I32_MAX = -2 ** 31, 2 ** 31 - 1


def _sat_i32(q):
    """XLA's float -> int32 conversion of floored values: NaN gives 0, out
    of range saturates (a plain .to(torch.int32) wraps instead)."""
    qd = torch.nan_to_num(q.to(torch.float64), nan=0.0)
    return qd.clamp(_I32_MIN, _I32_MAX).to(torch.int32)


def _cap_dim(used0, cap, ask):
    """c = max m >= 0 with used0 + m * ask <= cap, per node: the float
    quotient, then the reference's +-2 integer correction (binpack.py
    cap_dim). The predicate's multiply-add is one fma, as XLA's lowering
    fuses it; int32 throughout, wrapping as XLA's int32 adds do."""
    q = _sat_i32(torch.floor((cap - used0) / ask.clamp_min(1e-9)))

    def fits(m):
        return _fma(m.to(used0.dtype), ask, used0) <= cap

    q = torch.where(fits(q), q, q - 1)
    q = torch.where(fits(q), q, q - 1)
    q = q.clamp_min(0)
    q = torch.where(fits(q + 1), q + 1, q)
    q = torch.where(fits(q + 1), q + 1, q)
    q = torch.where(fits(q), q, torch.zeros_like(q))
    return torch.where(ask > 0, q, torch.full_like(q, 2 ** 30))


def wavefront_caps(const, init, batch):
    """Each node's capacity c for the lane's uniform ask, clip(c, 0, P),
    (E, N) int32, and the affinity column the compact rows carry (zero
    where the lane has none): the in-kernel wavefront's per-node work."""
    P = batch.ask_cpu.shape[1]
    ask_cpu, ask_mem = batch.ask_cpu[:, :1], batch.ask_mem[:, :1]
    ask_disk = batch.ask_disk[:, :1]
    n_dyn = batch.n_dyn_ports[:, :1]
    c = torch.minimum(_cap_dim(init.used_cpu, const.cpu_cap, ask_cpu),
                      _cap_dim(init.used_mem, const.mem_cap, ask_mem))
    c = torch.minimum(c, _cap_dim(init.used_disk, const.disk_cap, ask_disk))
    dyn = torch.div(init.dyn_avail, n_dyn.clamp_min(1), rounding_mode="floor")
    c = torch.minimum(c, torch.where(n_dyn > 0, dyn,
                                     torch.full_like(dyn, 2 ** 30)))
    one = torch.ones_like(c)
    zero = torch.zeros_like(c)
    c = torch.where(batch.has_static[:, :1],
                    torch.minimum(c, torch.where(init.static_free, one,
                                                 zero)), c)
    distinct0 = torch.where(const.distinct_job_level[:, None],
                            init.placed_job, init.placed)
    c = torch.where(const.distinct_hosts[:, None],
                    torch.minimum(c, torch.where(distinct0 > 0, zero, one)),
                    c)
    c = torch.where(const.feasible, c, zero).clamp(0, P)
    aff = torch.where(const.has_affinity[:, None], const.affinity,
                      torch.zeros_like(const.affinity))
    return c, aff


def wavefront_tables(const, init, batch, B: int = WAVE_B):
    """The device-side precompute of the in-kernel wavefront over E
    stacked lanes of tensors: (compact (E, P + B, 8), scal_f (E, 3),
    scal_i (E, 2) int32), the compact table's columns those of
    wave_compact's [c, used_cpu, used_mem, cpu_cap, mem_cap, placed,
    affinity, pos]. Rows past a lane's last fit node repeat node N-1's
    row with c = 0 and pos = N."""
    dt = const.cpu_cap.dtype
    E, N = const.cpu_cap.shape
    P = batch.ask_cpu.shape[1]
    C = P + B
    dev = const.cpu_cap.device
    c, aff = wavefront_caps(const, init, batch)

    # the first C fit nodes of each lane in shuffled order; N = none
    tak = c > 0
    kpos = torch.cumsum(tak.to(torch.int64), dim=1) - 1
    slot = torch.where(tak & (kpos < C), kpos, C)
    pos = torch.full((E, C + 1), N, dtype=torch.int64, device=dev)
    ar = torch.arange(N, device=dev).expand(E, N)
    pos.scatter_(1, slot, ar)
    pos = pos[:, :C]
    safe = pos.clamp_max(N - 1)
    cols = (c.to(dt), init.used_cpu, init.used_mem, const.cpu_cap,
            const.mem_cap, init.placed.to(dt), aff)
    compact = torch.stack([torch.gather(x, 1, safe) for x in cols]
                          + [pos.to(dt)], dim=2)
    compact[..., 0] = torch.where(pos < N, compact[..., 0],
                                  torch.zeros_like(compact[..., 0]))
    scal_f = torch.stack([batch.ask_cpu[:, 0], batch.ask_mem[:, 0],
                          batch.count[:, 0].to(dt)], dim=1)
    scal_i = torch.stack([batch.limit[:, 0].to(torch.int32),
                          batch.active.sum(dim=1).to(torch.int32)], dim=1)
    return compact.contiguous(), scal_f, scal_i


@jitcheck.plain_version
def wavefront_plain(const: NodeConst, init: NodeState,
                    batch: PlacementBatch, *, spread_alg: bool):
    """Plain PyTorch version of the in-kernel wavefront over E stacked
    lanes: wavefront_tables, then the per-placement step
    (wave_compact_plain with no spread columns). Returns (chosen int64,
    scores, n_yielded int64), each (E, P)."""
    compact, scal_f, scal_i = wavefront_tables(const, init, batch)
    E = compact.shape[0]
    dt, dev = compact.dtype, compact.device
    sp = WaveSpread(
        counts=torch.zeros((E, 0, 1), dtype=torch.int32, device=dev),
        desired=torch.zeros((E, 0, 1), dtype=dt, device=dev),
        has_targets=torch.zeros((E, 0), dtype=torch.bool, device=dev),
        weights=torch.zeros((E, 0), dtype=dt, device=dev),
        sum_weights=torch.zeros(E, dtype=dt, device=dev))
    return wave_compact_plain(compact, scal_f, scal_i,
                              batch.penalty_idx.to(torch.int32), sp,
                              spread_alg=spread_alg, B=WAVE_B)


def wavefront(const: NodeConst, init: NodeState, batch: PlacementBatch, *,
              spread_alg: bool):
    """In-kernel wavefront over E stacked lanes of tensors on one device:
    the plain version for CPU tensors, the wavefront kernel for CUDA
    tensors. Returns (chosen int64, scores, n_yielded int64), (E, P)."""
    dt = const.cpu_cap.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"cpu_cap dtype {dt} is not float32/float64")
    dev = const.cpu_cap.device
    E, N = const.cpu_cap.shape
    P = batch.ask_cpu.shape[1]
    trees = {"const": const, "state": init, "batch": batch}
    shapes = {"const": (E, N), "state": (E, N), "batch": (E, P)}
    for tree, f in WAVEFRONT_ARGS:
        t = getattr(trees[tree], f)
        shape = ((E,) if f in ("has_affinity", "distinct_hosts",
                               "distinct_job_level") else shapes[tree])
        _check(f"{tree}.{f}", t, dense._field_dtype(f, dt), len(shape), dev)
        if tuple(t.shape) != shape:
            raise ValueError(f"{tree}.{f} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
    if N < 1 or P < 1:
        raise ValueError("the wavefront needs N >= 1 and P >= 1")
    if dev.type == "cpu":
        return wavefront_plain(const, init, batch, spread_alg=spread_alg)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    C = P + WAVE_B
    compact = torch.empty((E, C, 8), dtype=dt, device=dev)
    scal_f = torch.empty((E, 3), dtype=dt, device=dev)
    # (E, 2) lane scalars (limit, n_active), then each lane's route
    scal_i = torch.empty(3 * E, dtype=torch.int32, device=dev)
    chosen = torch.empty((E, P), dtype=torch.int64, device=dev)
    scores = torch.empty((E, P), dtype=dt, device=dev)
    n_yielded = torch.empty((E, P), dtype=torch.int64, device=dev)
    kernels.WAVEFRONT.launch(
        dt, [getattr(trees[tree], f) for tree, f in WAVEFRONT_ARGS]
        + [compact, scal_f, scal_i, chosen, scores, n_yielded],
        [E, N, P, int(bool(spread_alg))])
    return chosen, scores, n_yielded


def solve_wavefront(const, init, batch, *, spread_alg: bool = False,
                    dtype_name=None, device: DeviceLike = None):
    """The in-kernel wavefront entry point (binpack.py solve_wavefront) on
    numpy lane tables: one lane ((N,) tables) or a stacked group (a
    leading eval axis), shipped through the fused transport to ``device``
    (default ``cuda``; no card raises). Returns host numpy (chosen int32,
    scores, n_yielded int32), (P,) or (E, P)."""
    dev = resolve_device(device)
    dtype_name = default_dtype_name(dev, dtype_name)
    single = np.asarray(const.cpu_cap).ndim == 1
    if single:
        const, init, batch = (type(t)(*(np.asarray(a)[None] for a in t))
                              for t in (const, init, batch))
    cast = dense.lane_casts(dtype_name)
    (c, s, b), _ = dense.fused_tensors((const, init, batch), (cast,) * 3,
                                       device=dev)
    chosen, scores, n_yielded = wavefront(c, s, b, spread_alg=spread_alg)
    with jitcheck.sanctioned_fetch("wave"):
        out = (chosen.to(torch.int32).cpu().numpy(), scores.cpu().numpy(),
               n_yielded.to(torch.int32).cpu().numpy())
    return tuple(x[0] for x in out) if single else out
