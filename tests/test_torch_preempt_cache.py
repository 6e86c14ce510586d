"""The windowed preemption kernel's search cache, modelled on the CPU.

csrc/wave_preempt.cu keeps each window slot's last eviction search
(met, eviction row, freed resources, net priority) in its buffer and
runs a search only where a slot needs one (feasible, no plain fit) and
its cached result is stale; the searches that must run form a work list
that the block's 16-lane groups share. A cached entry goes stale when
its slot is refilled, when its slot wins with a non-empty eviction row,
and when the winner bumps the count of a group one of the slot's
max_parallel candidates belongs to.

``cached_schedule`` below is that schedule in plain PyTorch, step for
step: the per-buffer cache and its fresh flags, the cached freed sums,
the invalidation rule and the work list, with each search on the work
list computed by the plain search (preempt._search_rows) on its own row.
It is held bit for bit against wave_preempt_plain (chosen, scores,
n_yielded, eviction rows and the group counts after the last step) and,
on a few worlds, against the reference's _solve_wave_preempt_impl, in
float32 and float64, at B 32 and 128 and A 16 and 64. The worlds come
from chip_smoke.preempt_fuzz_tables with max_parallel groups shared
across slots, zombie shifts (scarce capacity), frozen steps and
reschedule penalties, at tens of nodes. The tests also show that the
max_parallel rule is needed (a model without it goes wrong on those
worlds) and that on the tier-5 kind of lane the model runs far fewer
searches than slot-steps.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from nomad_tpu.solver import binpack as ref
from test_torch_preempt import TREES, _cast

from nomad_tpu_torch.solver import binpack as port_bp
from nomad_tpu_torch.solver import preempt
from nomad_tpu_torch.solver.binpack import (
    WPC_AFF, WPC_CC, WPC_CD, WPC_CDEV, WPC_CM, WPC_FEAS, WPC_PLACED,
    WPC_PLACED_JOB, WPC_POS, WPC_UC, WPC_UD, WPC_UM)
from nomad_tpu_torch.solver.scoring import (
    _anti, _binpack_raw, _preempt_score, _score, _score_preempt, _select,
    _winner)

torch.set_num_threads(1)

DTYPES = ("float64", "float32")


def _lanes(seed, feature_sets, dtype_name, *, n=40, n_pad=64, p=24,
           limit=5, A=16, G=4):
    """Fuzz lanes (every one with GPUs, so they stack) as the reference's
    tuples, and the port's stacked window inputs; G small so max_parallel
    groups are shared across slots."""
    rng = np.random.default_rng(seed)
    refs, dicts = [], []
    for feats in feature_sets:
        d = chip_smoke.preempt_fuzz_tables(
            np, rng, n=n, n_pad=n_pad, p=p, dtype=dtype_name, limit=limit,
            features=feats + ("devices",), A=A, G=G)
        refs.append(tuple(
            _cast(getattr(ref, name)(**{
                f: t[f] for f in getattr(ref, name)._fields if f in t}),
                dtype_name)
            for name, t in zip(TREES, d)))
        dicts.append(list(d))
    inp = preempt.wave_preempt_inputs(
        *chip_smoke.stack_preempt(np, port_bp, dicts), dtype_name=dtype_name)
    return refs, inp, preempt.wave_preempt_tensors(inp, torch.device("cpu"))


def cached_schedule(compact, cand, scal_f, scal_i, pen, counts0, *,
                    spread_alg, B, maxp_rule=True):
    """The kernel's schedule, one lane at a time. Returns (chosen, scores,
    n_yielded, evict_rows, counts, stats); stats counts slot-steps (the
    slots of every step that is not frozen), the searches the slots
    needed, those that ran, and the caches the max_parallel rule made
    stale. ``maxp_rule`` False leaves that rule out."""
    E, C, _ = compact.shape
    P = C - B
    A = cand["cpu"].shape[2]
    dt = compact.dtype
    zero = torch.zeros((), dtype=dt)
    neg_inf = torch.tensor(-float("inf"), dtype=dt)
    chosen = torch.full((E, P), -1, dtype=torch.long)
    scores = torch.empty((E, P), dtype=dt)
    n_yielded = torch.empty((E, P), dtype=torch.long)
    evict_rows = torch.zeros((E, P, A), dtype=torch.bool)
    counts_out = counts0.long().clone()
    stats = dict(slot_steps=0, needed=0, searches=0, maxp_stale=0)
    for e in range(E):
        ask_c, ask_m, ask_d, count = (scal_f[e, k] for k in range(4))
        L, n_active, job_prio, flag = (int(scal_i[e, k]) for k in range(4))
        counts = counts_out[e]
        # slots: compact row, copies, evicted mask, cached freed sums and
        # buffer; buffers: the cached search and its fresh flag
        row = list(range(B))
        buf = list(range(B))
        j = torch.zeros(B, dtype=torch.long)
        ev = torch.zeros((B, A), dtype=torch.bool)
        freed = torch.zeros((B, 3), dtype=dt)
        res = [None] * B
        fresh = [False] * B
        cursor, pending, frozen = B, -1, None
        for i in range(P):
            pen_i = int(pen[e, i])
            if frozen is not None and pen_i < 0:
                scores[e, i], n_yielded[e, i] = frozen
                continue
            stats["slot_steps"] += B
            rows = torch.tensor(row)
            slot = compact[e, rows]
            cd = {k: v[e, rows] for k, v in cand.items()}
            jf = j.to(dt)
            new_c = (slot[:, WPC_UC] + jf * ask_c - freed[:, 0]) + ask_c
            new_m = (slot[:, WPC_UM] + jf * ask_m - freed[:, 1]) + ask_m
            new_d = (slot[:, WPC_UD] + jf * ask_d - freed[:, 2]) + ask_d
            dcount = (slot[:, WPC_PLACED_JOB] if flag == 2
                      else slot[:, WPC_PLACED]) + jf
            feas = ((slot[:, WPC_FEAS] > 0.5)
                    & (slot[:, WPC_CDEV] - jf >= 1.0)
                    & ((flag == 0) | (dcount == 0.0)))
            fit = (feas & (new_c <= slot[:, WPC_CC])
                   & (new_m <= slot[:, WPC_CM]) & (new_d <= slot[:, WPC_CD]))
            need = (feas & ~fit).tolist()
            work = [s for s in range(B) if need[s] and not fresh[buf[s]]]
            stats["needed"] += sum(need)
            stats["searches"] += len(work)
            if work:
                w = torch.tensor(work)
                vn = cd["valid"][w] & ~ev[w]
                grp = cd["grp"][w].long()
                n_pre = torch.where(grp >= 0, counts[grp.clamp_min(0)],
                                    torch.zeros_like(grp))
                r = preempt._search_rows(
                    cd["cpu"][w], cd["mem"][w], cd["disk"][w], cd["prio"][w],
                    preempt._maxp_penalty(cd["maxp"][w], n_pre, dt), vn,
                    vn & ((job_prio - cd["prio"][w]) >= 10),
                    slot[w, WPC_CC], slot[w, WPC_CM], slot[w, WPC_CD],
                    ask_c.expand(len(work)), ask_m.expand(len(work)),
                    ask_d.expand(len(work)))
                for q, s in enumerate(work):
                    res[buf[s]] = tuple(x[q] for x in r)
                    fresh[buf[s]] = True
            # the cached results of the slots that need one
            met = torch.zeros(B, dtype=torch.bool)
            evict = torch.zeros((B, A), dtype=torch.bool)
            fr = torch.zeros((4, B), dtype=dt)
            for s in range(B):
                if need[s]:
                    m, ro, fc, fm, fd, npri = res[buf[s]]
                    met[s], evict[s] = m, ro
                    fr[:, s] = torch.stack([fc, fm, fd, npri])
            fit2 = ((new_c - fr[0] <= slot[:, WPC_CC])
                    & (new_m - fr[1] <= slot[:, WPC_CM])
                    & (new_d - fr[2] <= slot[:, WPC_CD]))
            fit_p = feas & ~fit & met & fit2
            coll = slot[:, WPC_PLACED] + jf
            anti = _anti(coll, count)
            is_pen = (pen_i >= 0) & (slot[:, WPC_POS] == float(pen_i))
            resched = torch.where(is_pen, -1.0, 0.0).to(dt)
            affs = slot[:, WPC_AFF]
            nscores = (1.0 + (coll > 0).to(dt) + is_pen.to(dt)
                       + (affs != 0.0).to(dt))
            other = (anti + resched) + affs
            cc = slot[:, WPC_CC].clamp_min(1e-9)
            cm = slot[:, WPC_CM].clamp_min(1e-9)
            bp = _binpack_raw(1.0 - new_c / cc, 1.0 - new_m / cm, spread_alg)
            bp_p = _binpack_raw(1.0 - (new_c - fr[0]) / cc,
                                1.0 - (new_m - fr[1]) / cm, spread_alg)
            final = torch.where(
                fit_p, _score_preempt(bp_p, other, _preempt_score(fr[3]),
                                      nscores),
                _score(bp, other, nscores))
            fit_c = fit | fit_p
            _, yielded, order, ny = _select(final[None], fit_c[None],
                                            torch.tensor([[L]]))
            w, best = _winner(torch.where(yielded, final[None], neg_inf),
                              yielded, order)
            w, ny = int(w[0]), int(ny[0])
            do = i < n_active and ny > 0
            if do:
                chosen[e, i] = int(slot[w, WPC_POS])
            scores[e, i] = best[0] if ny > 0 else neg_inf
            n_yielded[e, i] = ny
            # commit: one copy; a preempting winner's eviction row, freed
            # sums and group counts, and the caches that go stale
            bumped = set()
            if do:
                j[w] += 1
                if bool(fit_p[w]):
                    ro = evict[w]
                    evict_rows[e, i] = ro
                    ev[w] |= ro
                    fresh[buf[w]] = False
                    freed[w] = torch.stack([
                        torch.where(ev[w], cd[k][w], zero).sum()
                        for k in ("cpu", "mem", "disk")])
                    for a in ro.nonzero().flatten().tolist():
                        g = int(cd["grp"][w, a])
                        if g >= 0:
                            counts[g] += 1
                            bumped.add(g)
            if bumped and maxp_rule:
                for s in range(B):
                    mp = (cd["maxp"][s] > 0) & (cd["grp"][s] >= 0)
                    groups = set(cd["grp"][s][mp].tolist())
                    if fresh[buf[s]] and groups & bumped:
                        fresh[buf[s]] = False
                        stats["maxp_stale"] += 1
            # the previous winner shifts out if it is no option any more;
            # the refilled last slot takes its buffer
            z = max(pending, 0)
            zomb = pending >= 0 and not bool(fit_c[z])
            if zomb:
                b = buf[z]
                for lst in (row, buf):
                    del lst[z]
                row.append(min(cursor, C - 1))
                buf.append(b)
                fresh[b] = False
                keep = [s for s in range(B) if s != z]
                j = torch.cat([j[keep], torch.zeros(1, dtype=torch.long)])
                ev = torch.cat([ev[keep], torch.zeros((1, A),
                                                      dtype=torch.bool)])
                freed = torch.cat([freed[keep], torch.zeros((1, 3),
                                                            dtype=dt)])
                cursor += 1
            pending = ((w - 1 if zomb and w > z else w) if do else -1)
            if not do and not zomb and pen_i < 0:
                frozen = (scores[e, i].clone(), ny)
    return chosen, scores, n_yielded, evict_rows, counts_out, stats


def _assert_same(got, want):
    for name, g, w in zip(("chosen", "scores", "n_yielded", "evict_rows"),
                          got, want):
        chip_smoke.same_bits(torch, name, g, w)


FEATURES = (("maxp", "tiers", "penalties"), ("maxp", "scarce", "penalties"),
            ("maxp", "affinity"), ("tiers", "distinct"),
            ("scarce", "job_level"), ("inert",))

# (the plain search is slow on the CPU at A = 64: those worlds are cut to
# the max_parallel lanes and a few steps)
CASES = {
    # B 32, A 16: shared max_parallel groups, zombie shifts, penalties,
    # frozen steps (the scarce and inert lanes)
    "B32_A16": dict(seed=81, n=40, n_pad=64, p=24, limit=5, A=16),
    # the wide buffer: a limit-100 window
    "B128_A16": dict(seed=82, n=60, n_pad=64, p=12, limit=100, A=16,
                     lanes=4),
    # the widest candidate axis, every column in use
    "B32_A64": dict(seed=83, n=24, n_pad=32, p=8, limit=5, A=64, lanes=3,
                    many=True),
    "B128_A64": dict(seed=84, n=40, n_pad=64, p=4, limit=100, A=64,
                     lanes=2, many=True),
}


def _case(name, dtype_name):
    kw = dict(CASES[name])
    seed, many = kw.pop("seed"), kw.pop("many", False)
    feats = [f + ("many",) if many else f
             for f in FEATURES[:kw.pop("lanes", len(FEATURES))]]
    refs, inp, ten = _lanes(seed, feats, dtype_name, **kw)
    assert inp.B == (128 if kw["limit"] == 100 else 32)
    return refs, inp, ten


@pytest.mark.parametrize("dtype_name", DTYPES)
@pytest.mark.parametrize("case", list(CASES))
def test_cached_schedule_matches_plain(case, dtype_name):
    """The cached schedule equals wave_preempt_plain bit for bit, the
    group counts after the last step included, and runs fewer searches
    than the slots needed."""
    lanes, inp, ten = _case(case, dtype_name)
    want = preempt.wave_preempt_plain(*ten, spread_alg=False, B=inp.B)
    got = cached_schedule(*ten, spread_alg=False, B=inp.B)
    _assert_same(got[:4], want)
    assert torch.equal(got[4], chip_smoke.wave_preempt_final_counts(
        torch, preempt, ten, want).long())
    st = got[5]
    assert bool(want[3].any()), "no lane evicted"
    assert 0 < st["searches"] <= st["needed"] <= st["slot_steps"], st
    if CASES[case]["A"] == 16:
        # long enough for cached results to be reused (the A = 64 worlds
        # run a few steps only)
        assert st["searches"] < st["needed"], st


@pytest.mark.parametrize("dtype_name", DTYPES)
def test_cached_schedule_matches_reference(dtype_name):
    """Each lane of the B 32 world through the cached schedule against
    the reference's _solve_wave_preempt_impl (solve_lane_wave_preempt)."""
    lanes, inp, ten = _case("B32_A16", dtype_name)
    got = cached_schedule(*ten, spread_alg=False, B=inp.B)
    for e, rlane in enumerate(lanes):
        want = ref.solve_lane_wave_preempt(*rlane, spread_alg=False,
                                           dtype_name=dtype_name)
        P = np.asarray(want[0]).shape[0]
        np.testing.assert_array_equal(got[0][e, :P].numpy(), want[0])
        np.testing.assert_array_equal(got[1][e, :P].numpy(), want[1])
        np.testing.assert_array_equal(got[2][e, :P].numpy(), want[2])
        np.testing.assert_array_equal(got[3][e, :P].numpy(), want[3])


@pytest.mark.parametrize("dtype_name", DTYPES)
def test_max_parallel_rule_is_needed(dtype_name):
    """On the B 32 world the max_parallel rule makes caches stale, and a
    schedule without it reuses a stale search and goes wrong."""
    _, inp, ten = _case("B32_A16", dtype_name)
    want = preempt.wave_preempt_plain(*ten, spread_alg=False, B=inp.B)
    got = cached_schedule(*ten, spread_alg=False, B=inp.B)
    assert got[5]["maxp_stale"] > 0
    bad = cached_schedule(*ten, spread_alg=False, B=inp.B, maxp_rule=False)
    with pytest.raises(AssertionError):
        _assert_same(bad[:4], want)


@pytest.mark.parametrize("dtype_name", DTYPES)
def test_tier5_kind_searches_a_small_share_of_slot_steps(monkeypatch,
                                                         dtype_name):
    """The main path's kind of lane (chip_smoke.tier5_lanes: nodes 95%
    full of priority 10-40 one-alloc jobs, max_parallel 0, a one-GPU
    priority-70 ask) at tens of nodes: the cached schedule equals the
    plain version, and runs a small share of the searches its slots need
    (at full width nearly every slot-step needs one: the nodes are 95%
    full)."""
    from nomad_tpu_torch.solver import batch, service as svc
    from nomad_tpu_torch.tensor import pack as tp
    monkeypatch.setattr(chip_smoke, "N_NODES", 48)
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    world = chip_smoke.headline_world(np, tp)
    lanes = chip_smoke.tier5_lanes(np, tp, svc, world, dtype_name,
                                   n_lanes=2, n_place=40)
    (g,) = batch.fuse_lanes(lanes)
    assert g.wave
    inp, ten = preempt.wave_preempt_inputs(
        g.const, g.init, g.batch, g.ptab, g.pinit,
        dtype_name=dtype_name), None
    ten = preempt.wave_preempt_tensors(inp, torch.device("cpu"))
    want = preempt.wave_preempt_plain(*ten, spread_alg=False, B=inp.B)
    got = cached_schedule(*ten, spread_alg=False, B=inp.B)
    _assert_same(got[:4], want)
    st = got[5]
    assert bool((want[0] >= 0).any()) and bool(want[3].any())
    assert st["searches"] < 0.25 * st["needed"], st
    assert st["needed"] < st["slot_steps"], st
