"""The wave kernels' warp-synchronous step, modelled on the CPU.

csrc/wave_block.cu and csrc/wave_compact.cu (its step loop
wave_compact_kernel in csrc/wave_warp.cuh) run a lane in one warp, window
slot k = 32 r + lane in register word r. Their step differs from the
plain versions' in four ways, each modelled here in plain PyTorch and
held bit for bit against wave_compact_plain / wave_block_plain and the
reference's _solve_wave_compact_impl / _solve_wave_block_impl:

  * the window (select.go:38-77) from ballots: per word, the fit and low
    masks; a slot's inclusive counts are the popcounts under its lane
    mask plus the earlier words' popcounts (``ballot_window``);
  * the arg-best from redux over an order-preserving int image of the
    score (-0.0 taken as +0.0), then over order * B + slot
    (``redux_best``), and row 1's runner-up the same way over every slot;
  * cached heads: a slot's head terms are computed when it is loaded or
    refilled and recomputed only when its j changes (row 1: taken from
    the winner's stream at q = t, the same expressions; row 2: from the
    head warp's table of every slot's head at its next j, which it
    updates for the winner after each commit);
  * row 1's run width K = 15 (a stream value a lane pair, its two pows
    side by side), the last pair scoring the next refill row's head
    beside the stream; row 2's frozen lane repeating its output on steps
    without a penalty, unscored.
"""
import numpy as np
import pytest
import torch

from nomad_tpu.solver import binpack as ref
from test_torch_wave import (
    FUZZ_SHAPES, _assert_same, _empty_sp, _fuzz_lanes, _port_sp,
    _ref_compact, _t)
from test_torch_wave_worlds import (
    SPREAD_WORLDS, WORLDS, _ref_block, _world_lanes)

from nomad_tpu_torch.solver import wave
from nomad_tpu_torch.solver.binpack import MAX_SKIP
from nomad_tpu_torch.solver.scoring import (
    SKIP_THRESHOLD, _anti, _binpack_raw, _score, _select, _spread_boost,
    _winner)

torch.set_num_threads(1)

KERNEL_K = 15                          # wave_warp.cuh kRunK


def _words(x, B):
    """(E, B) -> (E, R, 32): slot k = 32 r + lane in word r."""
    return x.reshape(x.shape[0], B // 32, 32)


def ballot_window(fit, low, L):
    """The kernels' window from per-word ballots and popcounts. fit, low
    (E, B) bool, L (E, 1). Returns (yielded, order, n_yielded)."""
    E, B = fit.shape
    lanes = torch.arange(32)
    le = (lanes[None, :] <= lanes[:, None])          # [lane, other]
    out = []
    for m in (fit, low):
        w = _words(m, B).long()                       # (E, R, 32)
        below = (w[:, :, None, :] * le[None, None]).sum(-1)   # popc(m & le)
        tot = w.sum(-1)                               # popc(m) per word
        base = torch.cumsum(tot, dim=1) - tot
        out.append((below + base[..., None]).reshape(E, B))
    incl_f, incl_l = out
    tot_f = fit.long().sum(1, keepdim=True)
    tot_l = low.long().sum(1, keepdim=True)
    total_counted = tot_f - tot_l.clamp_max(MAX_SKIP)
    deficit = (L - torch.minimum(total_counted, L)).clamp_min(0)
    srank = incl_l.clamp_max(MAX_SKIP)
    skipped = low & (incl_l <= MAX_SKIP)
    cpos = incl_f - srank
    window = fit & ~skipped & (cpos <= L)
    fallback = skipped & (srank <= deficit)
    yielded = window | fallback
    order = torch.where(window, cpos, L + srank)
    n_yielded = sum(_words(yielded, B)[:, r].long().sum(-1)
                    for r in range(B // 32))
    return yielded, order, n_yielded


def order_key(x):
    """wave_warp.cuh order_key: an int64 tensor ordered as the scores,
    -0.0 and +0.0 one key."""
    x = torch.where(x == 0, torch.zeros_like(x), x)
    if x.dtype == torch.float32:
        b = x.contiguous().view(torch.int32).long()
        return torch.where(b >= 0, b, b ^ 0x7fffffff)
    b = x.contiguous().view(torch.int64)
    return torch.where(b >= 0, b, b ^ 0x7fffffffffffffff)


def redux_best(eff, on, order):
    """wave_warp.cuh warp_best: max key among slots with ``on``, then min
    order * B + slot among the slots at that key. Returns (slot, order)
    per lane; slot -1 where no slot is on."""
    E, B = eff.shape
    k = order_key(eff)
    floor = torch.iinfo(torch.int64).min
    m = torch.where(on, k, floor).max(dim=1, keepdim=True).values
    io = torch.where(on & (k == m), order * B + torch.arange(B),
                     torch.iinfo(torch.int64).max).min(dim=1).values
    none = ~on.any(dim=1)
    slot = torch.where(none, -1, io % B)
    return slot, torch.div(io - io % B, B, rounding_mode="floor")


def better_best(eff, y, order):
    """The reference kernels' better(): yielded first, higher eff (+-0
    equal), smaller order, smaller slot -- by a plain scan per lane."""
    out = []
    for e in range(eff.shape[0]):
        best = None
        for k in range(eff.shape[1]):
            key = (int(y[e, k]), float(eff[e, k]), -int(order[e, k]), -k)
            if best is None or key > best[0]:
                best = (key, k)
        out.append(best[1])
    return torch.tensor(out)


def _head(slot, j, ask_cpu, ask_mem, count, spread_alg):
    """head_terms (wave_common.cuh) on (E, X) slots: fit, binpack, coll,
    anti."""
    fit, binpack, coll, anti, _ = wave._slot_scores(
        slot, j, ask_cpu, ask_mem, count, spread_alg)
    return fit, binpack, coll, anti


def _f0(head, aff):
    fit, binpack, coll, anti = head
    dt = binpack.dtype
    nsc = 1.0 + (coll > 0).to(dt) + (aff != 0.0).to(dt)
    return _score(binpack, anti + aff, nsc)


def stream_values(ws, j_w, q, ask_cpu, ask_mem, count, spread_alg):
    """wave_block.cu's stream: the score of the winner's (j_w + q + 1)-th
    placement for each q, its expressions in the kernel's order. ws (E,
    W), j_w (E,) int, q (Q,) int. Returns (valid, val), (E, Q)."""
    dt = ws.dtype
    jq = j_w.to(dt)[:, None] + q.to(dt)[None, :]
    valid = jq < ws[:, 0:1]
    jp1q = jq + 1.0
    fcq = 1.0 - (ws[:, 1:2] + jp1q * ask_cpu) / ws[:, 3:4].clamp_min(1e-9)
    fmq = 1.0 - (ws[:, 2:3] + jp1q * ask_mem) / ws[:, 4:5].clamp_min(1e-9)
    bpq = _binpack_raw(fcq, fmq, spread_alg)
    collq = ws[:, 5:6] + jq
    nscq = ((1.0 + (collq > 0).to(dt))
            + torch.where(ws[:, 6:7] != 0.0, 1.0, 0.0).to(dt))
    return valid, _score(bpq, _anti(collq, count) + ws[:, 6:7], nscq)


def _bits(x):
    return x.contiguous().view(torch.int32 if x.dtype == torch.float32
                               else torch.int64)


class Check:
    """Invariants the models assert as they run."""

    def __init__(self):
        self.heads = 0
        self.windows = 0


def _shift(x, w, last, gate):
    """Saturation on (E, B, ...) per-slot state: slots >= w take the next
    slot's, the last slot ``last``; lanes where ``gate`` is set."""
    E, B = x.shape[:2]
    k = torch.arange(B)[None, :]
    take = (k >= w[:, None])
    while take.dim() < x.dim():
        take = take[..., None]
    nxt = torch.cat([x[:, 1:], last[:, None]], dim=1)
    g = gate.view(E, *([1] * (x.dim() - 1)))
    return torch.where(g & take, nxt, x)


def warp_compact_model(compact, scal_f, scal_i, pen, sp, *, spread_alg, B,
                       check=None, recompute=True, reg_spreads=None):
    """The per-placement step as wave_compact_kernel runs it, batched over
    lanes: cached heads, the ballot window, the redux arg-best, the head
    warp's tables (every slot's head at j + 1, the next refill row's at
    j = 0) from which the winner takes its new head (or not, with
    ``recompute=False``) and the refilled slot its head, the even form's
    statistics refreshed only for bumped spreads, and a frozen lane's
    steps without a penalty repeating its output unscored. Spreads from
    ``reg_spreads`` on (the kernel's SM, when S exceeds it) take their
    value index from the slot's compact row, whose number the slots carry
    and shift, and their statistics afresh at every step."""
    E, C, W = compact.shape
    P = C - B
    S = W - 8
    SM = S if reg_spreads is None else min(S, reg_spreads)
    dt = compact.dtype
    ask_cpu, ask_mem, count = (scal_f[:, k:k + 1] for k in range(3))
    L = scal_i[:, 0:1].long()
    n_active = scal_i[:, 1].long()
    counts = sp.counts.long().clone()
    wfrac = sp.weights / sp.sum_weights.clamp_min(1e-9)[:, None]
    ar = torch.arange(E)
    neg_inf = torch.tensor(-float("inf"), dtype=dt)

    def stats(c):
        present = c > 0
        mn = torch.where(present, c, 2 ** 31 - 1).min(dim=-1).values
        mx = torch.where(present, c, 0).max(dim=-1).values
        return mn, mx, present.any(dim=-1)

    smin, smax, sany = stats(counts)                 # (E, S)
    slot = compact[:, :B].clone()
    rw = torch.arange(B).repeat(E, 1)               # the slots' rows
    j = torch.zeros((E, B), dtype=torch.long)
    head = list(_head(slot, j, ask_cpu, ask_mem, count, spread_alg))
    cursor = torch.full((E,), B, dtype=torch.long)
    # the head warp's tables: every slot's head at j + 1, and the next
    # refill row's head at j = 0
    zero = torch.zeros((E, 1), dtype=torch.long)
    hnext = list(_head(slot, j + 1, ask_cpu, ask_mem, count, spread_alg))
    hrow = _head(compact[ar, cursor.clamp_max(C - 1)][:, None], zero,
                 ask_cpu, ask_mem, count, spread_alg)
    chosen = torch.full((E, P), -1, dtype=torch.long)
    scores = torch.empty((E, P), dtype=dt)
    n_yielded = torch.empty((E, P), dtype=torch.long)
    frozen = torch.zeros(E, dtype=torch.bool)
    frozen_sc = torch.zeros(E, dtype=dt)
    frozen_ny = torch.zeros(E, dtype=torch.long)
    pen = pen.long()
    for base in range(0, P, 32):            # the kernel's chunks of steps
        for i in range(base, min(base + 32, P)):
            pen_i = pen[:, i:i + 1]
            # frozen lanes without a penalty here repeat their output
            rep = frozen & (pen_i[:, 0] < 0)
            fit, binpack, coll, anti = head
            is_pen = (pen_i >= 0) & (slot[..., 7] == pen_i.to(dt))
            resched = torch.where(is_pen, -1.0, 0.0).to(dt)
            total = torch.zeros((E, B), dtype=dt)
            for s in range(S):
                vidx = slot[..., 8 + s].long()
                if s < SM:
                    # the kernel's statistics against the plain form's
                    want = stats(counts[:, s])
                    assert torch.equal(smin[:, s], want[0])
                    assert torch.equal(smax[:, s], want[1])
                    assert torch.equal(sany[:, s], want[2])
                else:
                    # past the registers: the index from the slot's row
                    row_v = compact[ar[:, None], rw, 8 + s].long()
                    assert torch.equal(row_v, vidx)
                    vidx = row_v
                total = total + _spread_boost(
                    vidx, counts[:, s], sp.desired[:, s],
                    sp.has_targets[:, s:s + 1], wfrac[:, s:s + 1])
            aff = slot[..., 6]
            nscores = (1.0 + (coll > 0).to(dt) + is_pen.to(dt)
                       + (aff != 0.0).to(dt) + (total != 0.0).to(dt))
            fin = _score(binpack, ((anti + resched) + aff) + total, nscores)
            low = fit & (fin <= SKIP_THRESHOLD)
            yielded, order, ny = ballot_window(fit, low, L)
            if check is not None:
                _, y_ref, o_ref, ny_ref = _select(fin, fit, L)
                assert torch.equal(yielded, y_ref)
                assert torch.equal(order, o_ref)
                assert torch.equal(ny, ny_ref)
                check.windows += 1
            w, _ = redux_best(fin, yielded, order)
            w = w.clamp_min(0)
            any_y = ny > 0
            score_out = torch.where(any_y, fin[ar, w], neg_inf)
            do = ~rep & (i < n_active) & any_y
            stop = ~rep & ~do & (pen_i[:, 0] < 0)
            frozen_sc = torch.where(stop, score_out, frozen_sc)
            frozen_ny = torch.where(stop, ny, frozen_ny)
            chosen[:, i] = torch.where(do, slot[ar, w, 7].long(), -1)
            scores[:, i] = torch.where(rep, frozen_sc, score_out)
            n_yielded[:, i] = torch.where(rep, frozen_ny, ny)
            frozen = frozen | stop
            j_w = j[ar, w] + do.long()
            j[ar, w] = j_w
            sat = do & (j_w.to(dt) >= slot[ar, w, 0])
            for s in range(S):
                vw = (slot[ar, w, 8 + s] if s < SM
                      else compact[ar, rw[ar, w], 8 + s]).long()
                bump = do & (vw >= 0)
                counts[ar, s, vw.clamp_min(0)] += bump.long()
                if s >= SM:
                    continue
                mn, mx, an = stats(counts[:, s])
                smin[:, s] = torch.where(bump, mn, smin[:, s])
                smax[:, s] = torch.where(bump, mx, smax[:, s])
                sany[:, s] = torch.where(bump, an, sany[:, s])
            # the winner's head at its new j, where it did not saturate: the
            # head warp's next head; the head warp then scores its next one
            keep = do & ~sat
            if bool(keep.any()):
                if recompute:
                    for x, n in zip(head, hnext):
                        x[ar, w] = torch.where(keep, n[ar, w], x[ar, w])
                hw = _head(slot[ar, w][:, None], j_w[:, None] + 1, ask_cpu,
                           ask_mem, count, spread_alg)
                for x, n in zip(hnext, hw):
                    x[ar, w] = torch.where(keep, n[:, 0], x[ar, w])
            # saturation: shift left, refill the last slot with row
            # min(cursor, C - 1), its head at j = 0 (hrow) and j = 1
            if bool(sat.any()):
                row = compact[ar, cursor.clamp_max(C - 1)]
                hl = _head(row[:, None], zero + 1, ask_cpu, ask_mem, count,
                           spread_alg)
                slot = _shift(slot, w, row, sat)
                rw = _shift(rw, w, cursor.clamp_max(C - 1), sat)
                j = _shift(j, w, torch.zeros(E, dtype=torch.long), sat)
                head = [_shift(x, w, n[:, 0], sat)
                        for x, n in zip(head, hrow)]
                hnext = [_shift(x, w, n[:, 0], sat)
                         for x, n in zip(hnext, hl)]
                cursor = cursor + sat.long()
                nrow = _head(compact[ar, cursor.clamp_max(C - 1)][:, None],
                             zero, ask_cpu, ask_mem, count, spread_alg)
                hrow = [torch.where(sat[:, None], a, b)
                        for a, b in zip(nrow, hrow)]
            if check is not None:
                for have, jj in ((head, j), (hnext, j + 1)):
                    fresh = _head(slot, jj, ask_cpu, ask_mem, count,
                                  spread_alg)
                    same = all(torch.equal(_bits(a) if a.is_floating_point()
                                           else a,
                                           _bits(b) if b.is_floating_point()
                                           else b)
                               for a, b in zip(have, fresh))
                    if recompute:
                        assert same, f"cached heads went stale at step {i}"
                check.heads += 1
    return chosen, scores, n_yielded


def warp_block_model(compact, scal_f, scal_i, *, spread_alg, B,
                     check=None):
    """The run decision as wave_block_kernel runs it, batched over lanes:
    cached (fit, f0), the ballot window, the redux winner and runner-up,
    the stream over q < K = 15 with the refill row's head beside it, the
    winner's new head from the stream at q = t."""
    E, C, _ = compact.shape
    P = C - B
    dt = compact.dtype
    ask_cpu, ask_mem, count = (scal_f[:, k:k + 1] for k in range(3))
    L = scal_i[:, 0:1].long()
    n_active = scal_i[:, 1].long()
    ar = torch.arange(E)
    K = KERNEL_K
    q = torch.arange(K)
    neg_inf = torch.tensor(-float("inf"), dtype=dt)
    slot = compact[:, :B].clone()
    j = torch.zeros((E, B), dtype=torch.long)
    h = _head(slot, j, ask_cpu, ask_mem, count, spread_alg)
    fit, f0 = h[0], _f0(h, slot[..., 6])
    cursor = torch.full((E,), B, dtype=torch.long)
    p = torch.zeros(E, dtype=torch.long)
    done = torch.zeros(E, dtype=torch.bool)
    ch = torch.full((E, P + K), -1, dtype=torch.long)
    sc = torch.full((E, P + K), -float("inf"), dtype=dt)
    nyb = torch.zeros((E, P + K), dtype=torch.long)
    while True:
        live = (p < n_active) & ~done
        if not bool(live.any()):
            break
        low = fit & (f0 <= SKIP_THRESHOLD)
        y, order, ny = ballot_window(fit, low, L)
        any_y = ny > 0
        w, w_order = redux_best(f0, y, order)
        w = w.clamp_min(0)
        if check is not None:
            assert torch.equal(w[any_y], _winner(
                torch.where(y, f0, neg_inf), y, order)[0][any_y])
        # frozen runner-up over every slot: non-yielded and the winner at
        # -inf, ties to the smallest order
        eff_o = torch.where(y, f0, neg_inf)
        eff_o[ar, w] = neg_inf
        ro, ru_order = redux_best(eff_o, torch.ones_like(y), order)
        rub = eff_o[ar, ro]
        ws = slot[ar, w]
        j_w = j[ar, w]
        valid, vals = stream_values(ws, j_w, q, ask_cpu, ask_mem, count,
                                    spread_alg)
        # lane K: row nx's head at j = 0, the same expressions
        nx = compact[ar, cursor.clamp_max(C - 1)]
        valid_x, val_x = stream_values(nx, torch.zeros(E, dtype=torch.long),
                                       q[:1], ask_cpu, ask_mem, count,
                                       spread_alg)
        low_w = low[ar, w][:, None]
        win_q = ((vals > rub[:, None])
                 | ((vals == rub[:, None])
                    & (w_order.to(dt)[:, None] < ru_order.to(dt)[:, None]))
                 | (q == 0)[None, :])
        cross = torch.where(low_w, vals > SKIP_THRESHOLD,
                            vals <= SKIP_THRESHOLD) & (q > 0)[None, :]
        stop = ~valid | ~win_q | cross | (q[None, :] >= (n_active - p)[:, None])
        tlim = torch.where(stop, q[None, :], K).min(dim=1).values
        q_sat = (ws[:, 0] - 1.0 - j_w.to(dt)).long()
        has_sat = (q_sat < K) & (q_sat < tlim)
        t = torch.where(has_sat, q_sat + 1, tlim)
        active = any_y & live
        t = torch.where(active, t, 0)
        has_sat = has_sat & active
        emit = q[None, :] < t[:, None]
        idx = torch.where(emit, p[:, None] + q[None, :], P + K - 1)
        rows = ar[:, None].expand_as(idx)
        ch[rows[emit], idx[emit]] = ws[:, 7].long()[:, None].expand_as(
            idx)[emit]
        sc[rows[emit], idx[emit]] = vals[emit]
        nyb[rows[emit], idx[emit]] = ny[:, None].expand_as(idx)[emit]
        # the winner's new head: the stream value at q = t (a direct
        # head at t = K); cached heads are never recomputed otherwise
        keep = active & ~has_sat
        j_new = j_w + t
        tq = t.clamp_max(K - 1)
        f0_n = vals[ar, tq]
        fit_n = valid[ar, tq]
        full = keep & (t == K)
        if bool(full.any()):
            hk = _head(ws[:, None], j_new[:, None], ask_cpu, ask_mem, count,
                       spread_alg)
            f0_n = torch.where(full, _f0(hk, ws[:, None, 6])[:, 0], f0_n)
            fit_n = torch.where(full, hk[0][:, 0], fit_n)
        if check is not None and bool(keep.any()):
            hk = _head(ws[:, None], j_new[:, None], ask_cpu, ask_mem, count,
                       spread_alg)
            f0_h = _f0(hk, ws[:, None, 6])[:, 0]
            assert torch.equal(_bits(f0_n[keep]), _bits(f0_h[keep]))
            assert torch.equal(fit_n[keep], hk[0][keep, 0])
            check.heads += int(keep.sum())
        j[ar, w] = torch.where(active, j_new, j_w)
        f0[ar, w] = torch.where(keep, f0_n, f0[ar, w])
        fit[ar, w] = torch.where(keep, fit_n, fit[ar, w])
        slot = _shift(slot, w, nx, has_sat)
        j = _shift(j, w, torch.zeros(E, dtype=torch.long), has_sat)
        f0 = _shift(f0, w, val_x[:, 0], has_sat)
        fit = _shift(fit, w, valid_x[:, 0], has_sat)
        cursor = cursor + has_sat.long()
        done = done | (live & ~any_y)
        p = p + t
    low = fit & (f0 <= SKIP_THRESHOLD)
    y, order, ny_f = ballot_window(fit, low, L)
    wf, _ = redux_best(f0, y, order)
    best = torch.where(ny_f > 0, f0[ar, wf.clamp_min(0)], neg_inf)
    fill = torch.arange(P + K)[None, :] >= p[:, None]
    ch = torch.where(fill, -1, ch)
    sc = torch.where(fill, best[:, None], sc)
    nyb = torch.where(fill, ny_f[:, None], nyb)
    return ch[:, :P], sc[:, :P], nyb[:, :P]


# --------------------------------------------------------------------------
# The step's pieces.

@pytest.mark.parametrize("R", [1, 4])
def test_ballot_window_is_the_select_scan(R):
    """The per-word ballot counts give select_slot's yielded, order and
    n_yielded, for limits below, inside and past the buffer."""
    B = 32 * R
    rng = np.random.default_rng(R)
    E = 64
    for L_val in (-1, 0, 1, 3, 14, 100, B + 5):
        fit = torch.from_numpy(rng.random((E, B)) < rng.random((E, 1)))
        low = fit & torch.from_numpy(rng.random((E, B)) < rng.random((E, 1)))
        L = torch.full((E, 1), L_val, dtype=torch.long)
        final = torch.where(low, -1.0, 1.0).to(torch.float64)
        low_r, y_r, o_r, ny_r = _select(final, fit, L)
        assert torch.equal(low_r, low)
        y, o, ny = ballot_window(fit, low, L)
        assert torch.equal(y, y_r)
        assert torch.equal(o, o_r)
        assert torch.equal(ny, ny_r)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_redux_key_order_is_better(dtype):
    """The key image orders scores as the values, with -0.0 == +0.0 and
    -inf below every finite score; the two-pass arg-best picks
    better()'s winner on adversarial ties (+-0.0, -inf among yielded and
    non-yielded slots, equal scores at different orders), and the
    runner-up pass over every slot gives the plain version's frozen
    runner-up score and order."""
    vals = torch.tensor([-float("inf"), -3.5, -1.0, -1e-30, -0.0, 0.0,
                         1e-30, 0.25, 1.0, float("inf")], dtype=dtype)
    k = order_key(vals)
    for a in range(len(vals)):
        for b in range(len(vals)):
            assert (k[a] > k[b]) == bool(vals[a] > vals[b])
            assert (k[a] == k[b]) == bool(vals[a] == vals[b])
    rng = np.random.default_rng(7)
    B = 64
    pool = np.array([-np.inf, -0.0, 0.0, 0.5, 0.5, -0.25, 1.0])
    E = 200
    eff = torch.from_numpy(rng.choice(pool, size=(E, B))).to(dtype)
    y = torch.from_numpy(rng.random((E, B)) < 0.4)
    y[::7] = False                                   # nothing yields
    order = torch.from_numpy(rng.integers(0, 6, size=(E, B)))
    w, w_order = redux_best(eff, y, order)
    want = better_best(eff, y, order)
    has = y.any(dim=1)
    assert torch.equal(w[has], want[has])
    assert bool((w[~has] == -1).all())
    assert torch.equal(w_order[has], order[torch.arange(E), w][has])
    # among yielded slots the winner is also the plain version's
    neg = torch.tensor(-float("inf"), dtype=dtype)
    eff_y = torch.where(y, eff, neg)
    w_plain, best = _winner(eff_y, y, order)
    # orders are unique among yielded slots in the kernels; here only the
    # lanes whose yielded orders are unique are the plain version's case
    uniq = torch.tensor([len(set(order[e][y[e]].tolist()))
                         == int(y[e].sum()) for e in range(E)])
    sel = has & uniq
    assert torch.equal(w[sel], w_plain[sel])
    assert torch.equal(eff[torch.arange(E), w][has], best[has])
    # runner-up over every slot: -inf ties fall back to the least order
    eff_o = eff_y.clone()
    eff_o[torch.arange(E), w.clamp_min(0)] = neg
    ro, ru_order = redux_best(eff_o, torch.ones_like(y), order)
    rub = eff_o.max(dim=1).values
    rub_ord = torch.where(eff_o == rub[:, None], order, 2 ** 31 - 1).min(
        dim=1).values
    assert torch.equal(eff_o[torch.arange(E), ro] == rub,
                       torch.ones(E, dtype=torch.bool))
    assert torch.equal(ru_order, rub_ord)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("spread_alg", [False, True])
def test_stream_at_t_is_the_head(dtype, spread_alg):
    """The stream value at q (the run-block kernel's expressions) equals
    the head f0 at j + q (head_terms and final_score) bit for bit, over
    j, capacities, collisions, affinities and counts."""
    rng = np.random.default_rng(11 + spread_alg)
    E = 400
    cm = np.zeros((E, 8), dtype=dtype)
    ask = rng.choice([250.0, 500.0, 1000.0], size=(E, 1))
    cpu = rng.choice([2000.0, 4000.0, 8000.0, 0.0], size=E)
    cm[:, 0] = rng.integers(0, 40, size=E)
    cm[:, 1] = rng.integers(0, 3, size=E) * ask[:, 0]
    cm[:, 2] = rng.integers(0, 3, size=E) * 128.0
    cm[:, 3] = cpu
    cm[:, 4] = cpu * 2
    cm[:, 5] = rng.choice([0.0, 0.0, 1.0, 2.0, 50.0], size=E)
    cm[:, 6] = rng.choice([0.0, 0.5, -0.25, 1.0, -1.0, -0.0], size=E)
    cm[:, 7] = np.arange(E)
    ws = torch.from_numpy(cm)
    ask_cpu = torch.from_numpy(ask.astype(dtype))
    ask_mem = torch.full((E, 1), 128.0, dtype=ws.dtype)
    count = torch.from_numpy(rng.choice([1.0, 4.0, 30.0, 2000.0],
                                        size=(E, 1)).astype(dtype))
    j_w = torch.from_numpy(rng.integers(0, 30, size=E))
    q = torch.arange(KERNEL_K + 1)
    valid, vals = stream_values(ws, j_w, q, ask_cpu, ask_mem, count,
                                spread_alg)
    jj = j_w[:, None] + q[None, :]
    slots = ws[:, None, :].expand(E, len(q), 8)
    hk = _head(slots, jj, ask_cpu, ask_mem, count, spread_alg)
    f0 = _f0(hk, slots[..., 6])
    assert torch.equal(_bits(vals), _bits(f0))
    assert torch.equal(valid, hk[0])


# --------------------------------------------------------------------------
# The models against the plain versions and the reference.

MODEL_SHAPES = [s for s in FUZZ_SHAPES if s[1] in (32, 128)]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("C,B,L", MODEL_SHAPES)
def test_models_on_fuzz(C, B, L, dtype):
    """Both models equal the plain versions and the reference's compact
    program on the test_torch_wave fuzz lanes, the compact one also with
    reschedule penalties; every cached head equals a fresh one after
    every step, and the ballot window equals _select."""
    dn = np.dtype(dtype).name
    cm, sf, si, pen = _fuzz_lanes(C, B, L, dtype)
    sp = _empty_sp(cm.shape[0], dtype)
    want = _ref_compact(cm, sf, si, pen, sp, spread_alg=False, dtype_name=dn,
                        B=B)
    chk = Check()
    args = (_t(cm), _t(sf), _t(si))
    got_b = warp_block_model(*args, spread_alg=False, B=B, check=chk)
    _assert_same(want, got_b, dtype)
    _assert_same(want, wave.wave_block_plain(*args, spread_alg=False, B=B),
                 dtype)
    rng = np.random.default_rng(C + B)
    hot = rng.random(pen.shape) < 0.3
    pen[hot] = rng.integers(0, C, size=int(hot.sum()))
    want = _ref_compact(cm, sf, si, pen, sp, spread_alg=False,
                        dtype_name=dn, B=B)
    got = warp_compact_model(*args, _t(pen), _port_sp(sp), spread_alg=False,
                             B=B, check=chk)
    _assert_same(want, got, dtype)
    plain = wave.wave_compact_plain(*args, _t(pen), _port_sp(sp),
                                    spread_alg=False, B=B)
    for g, p_ in zip(got, plain):
        assert torch.equal(_bits(g) if g.is_floating_point() else g,
                           _bits(p_) if p_.is_floating_point() else p_)
    assert chk.heads > 0 and chk.windows > 0


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("world,spread_alg", [
    ("plain", False), ("exhaustion", False), ("low_score", True),
    ("wide_affinity", False)])
def test_models_on_worlds(world, spread_alg, dtype):
    """On the test_wavefront worlds both models equal the reference's
    block program bit for bit (B 32 and, for wide_affinity, 128)."""
    dn = np.dtype(dtype).name
    cm, sf, si, pen, sp, B = _world_lanes(
        [100 * sorted(WORLDS).index(world) + k for k in range(4)], dtype,
        **WORLDS[world])
    want = _ref_block(cm, sf, si, pen, spread_alg=spread_alg, dtype_name=dn,
                      B=B)
    args = (_t(cm), _t(sf), _t(si))
    got_b = warp_block_model(*args, spread_alg=spread_alg, B=B,
                             check=Check())
    _assert_same(want, got_b, dtype)
    got_c = warp_compact_model(*args, _t(pen), _port_sp(sp),
                               spread_alg=spread_alg, B=B, check=Check())
    _assert_same(want, got_c, dtype)


def _spread_world_lanes(dtype, kw):
    """Five stacked worlds of ``kw``, reschedule penalties on the last
    two."""
    cm, sf, si, pen, sp, B = _world_lanes(
        [1000 + 7 * k for k in range(3)], dtype, **kw)
    cm2, sf2, si2, pen2, sp2, _ = _world_lanes(
        [1100 + 7 * k for k in range(2)], dtype, penalties=True, **kw)
    cm, sf, si, pen = (np.concatenate(x) for x in
                       ((cm, cm2), (sf, sf2), (si, si2), (pen, pen2)))
    sp = ref._WaveSpread(*(np.concatenate(x) for x in zip(sp, sp2)))
    assert cm.shape[2] == 8 + kw["spreads"] and (pen >= 0).any()
    return cm, sf, si, pen, sp, B


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("world", ["even", "target", "three"])
def test_compact_model_on_spread_worlds(world, dtype):
    """Spread lanes (S = 2 at B = 128, and S = 3) with penalties on two of
    five lanes: the compact model, with the even form's statistics
    refreshed only for the spreads the winner bumps, equals the
    reference."""
    dn = np.dtype(dtype).name
    cm, sf, si, pen, sp, B = _spread_world_lanes(dtype, SPREAD_WORLDS[world])
    assert B == 128
    want = _ref_compact(cm, sf, si, pen, sp, spread_alg=False,
                        dtype_name=dn, B=B)
    got = warp_compact_model(_t(cm), _t(sf), _t(si), _t(pen), _port_sp(sp),
                             spread_alg=False, B=B, check=Check())
    _assert_same(want, got, dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("spreads,reg_spreads", [(3, 2), (3, 0), (17, 16)])
def test_compact_model_spreads_past_registers(spreads, reg_spreads, dtype):
    """Spreads past the kernel's register-held ones (S > kMaxSpreads = 16,
    and here also fewer held): their value indexes come from the slots'
    compact rows, carried through every shift, and their statistics
    afresh each step; the results equal the plain version and the
    reference bit for bit."""
    dn = np.dtype(dtype).name
    kw = dict(SPREAD_WORLDS["three"], spreads=spreads)
    cm, sf, si, pen, sp, B = _spread_world_lanes(dtype, kw)
    want = _ref_compact(cm, sf, si, pen, sp, spread_alg=False,
                        dtype_name=dn, B=B)
    args = (_t(cm), _t(sf), _t(si), _t(pen), _port_sp(sp))
    got = warp_compact_model(*args, spread_alg=False, B=B, check=Check(),
                             reg_spreads=reg_spreads)
    _assert_same(want, got, dtype)
    plain = wave.wave_compact_plain(*args, spread_alg=False, B=B)
    for g, p_ in zip(got, plain):
        assert torch.equal(_bits(g) if g.is_floating_point() else g,
                           _bits(p_) if p_.is_floating_point() else p_)


def test_winner_head_recompute_is_needed():
    """Without recomputing the winner's head after a placement the cached
    heads go stale and the decisions leave the plain version's: the
    recompute rule is needed, not only sufficient."""
    cm, sf, si, pen = _fuzz_lanes(160, 32, 14, np.float64)
    sp = _port_sp(_empty_sp(cm.shape[0], np.float64))
    args = (_t(cm), _t(sf), _t(si), _t(pen), sp)
    want = wave.wave_compact_plain(*args, spread_alg=False, B=32)
    got = warp_compact_model(*args, spread_alg=False, B=32,
                             recompute=False)
    assert not all(torch.equal(g, w) for g, w in zip(got, want))
