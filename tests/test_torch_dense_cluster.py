"""The dense kernels' cluster walk, modelled on the CPU.

csrc/dense_scan.cu and csrc/dense_preempt.cu split each lane's window
walk over a thread-block cluster of C blocks (dense_common.cuh
cluster_walk): tiles of C * sub nodes in window order, block c owning
the sub nodes from t * C * sub + c * sub of tile t; rounds of K tiles;
per round the blocks exchange their (fit, low) counts per tile, whose
exclusive prefix gives every node its global skip rank and window
position; skipped options are published by
their global skip rank; every block stops after the round in which
`limit` options are counted; the blocks' best records and the fallback
skipped options are merged with the kernels' total order; every block
applies the winner's values to its own replica of the lane's count
tables. A CUDA kernel cannot run here, so this file holds a plain model
of that split walk (used by these tests only) and checks that it equals
the plain versions, ``dense.dense_scan_plain`` and
``preempt.dense_preempt_plain`` (themselves held against the JAX
programs in tests/test_torch_dense.py and tests/test_torch_preempt.py),
for C in {1, 2, 4, 16}: decisions, n_yielded, eviction rows and the
final state exactly, scores bit for bit, in float32 and float64.

Worlds: numpy-seeded fuzz lanes from chip_smoke.dense_fuzz_tables (a few
hundred nodes) and chip_smoke.preempt_fuzz_tables (tens of nodes: the
plain eviction search is slow on the CPU), with limits below and above
the node count, low-score skips and scarce capacity.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from nomad_tpu_torch.solver import binpack as port_bp
from nomad_tpu_torch.solver import dense, preempt
from nomad_tpu_torch.solver.scoring import MAX_SKIP, SKIP_THRESHOLD

torch.set_num_threads(1)

CLUSTERS = (1, 2, 4, 16)
DTYPES = ("float32", "float64")


# --------------------------------------------------------------------------
# the model

def split_walk(final, fit, limit, C, sub, K=1):
    """The cluster walk's selection for E lanes: (w, best, ny, rounds),
    (E,) each. The nodes are cut into tiles of C * sub, block c owning
    the sub from t * C * sub + c * sub of tile t; a round covers K
    tiles. w is the winner's node (0 where nothing
    yields, as the plain versions' arg-best gives), best its score (-inf
    where nothing yields), rounds the rounds each lane's walk took."""
    E, N = fit.shape
    low = fit & (final <= SKIP_THRESHOLD)
    out = []
    for e in range(E):
        L = int(limit[e])
        fit_base = low_base = rounds = 0
        recs = [None] * C          # each block's best (score, order, node)
        skips = {}                 # global skip rank -> (score, node)
        for base in range(0, N, K * C * sub):
            rounds += 1
            spans = [[(min(base + (k * C + c) * sub, N),
                       min(base + (k * C + c + 1) * sub, N))
                      for c in range(C)] for k in range(K)]
            # the counts each block publishes per chunk
            cnt = [[(int(fit[e, lo:hi].sum()), int(low[e, lo:hi].sum()))
                    for lo, hi in row] for row in spans]
            for k in range(K):
                for c, (lo, hi) in enumerate(spans[k]):
                    # the exclusive prefix: earlier chunks, then the
                    # blocks before c in this chunk
                    pre_fit = fit_base + sum(f for f, _ in cnt[k][:c])
                    pre_low = low_base + sum(lw for _, lw in cnt[k][:c])
                    f = fit[e, lo:hi]
                    lw = low[e, lo:hi]
                    skip_rank = pre_low + torch.cumsum(lw.long(), dim=0)
                    srank = skip_rank.clamp_max(MAX_SKIP)
                    skipped = lw & (skip_rank <= MAX_SKIP)
                    cpos = pre_fit + torch.cumsum(f.long(), dim=0) - srank
                    window = f & ~skipped & (cpos <= L)
                    for j in torch.nonzero(window).flatten().tolist():
                        key = (float(final[e, lo + j]), int(cpos[j]),
                               lo + j)
                        if recs[c] is None or _better(key, recs[c]):
                            recs[c] = key
                    for j in torch.nonzero(skipped).flatten().tolist():
                        skips[int(srank[j])] = (final[e, lo + j], lo + j)
                fit_base += sum(f for f, _ in cnt[k])
                low_base += sum(lw for _, lw in cnt[k])
            if fit_base - min(low_base, MAX_SKIP) >= L:
                break
        tot_skipped = min(low_base, MAX_SKIP)
        tot_counted = fit_base - tot_skipped
        deficit = max(0, L - min(tot_counted, L))
        ny = min(tot_counted, L) + min(deficit, tot_skipped)
        # the records in block order, then the fallback in skip order
        cands = [r for r in recs if r is not None] + [
            (float(skips[r][0]), L + r, skips[r][1])
            for r in range(1, min(deficit, tot_skipped) + 1)]
        win = None
        for key in cands:
            if win is None or _better(key, win):
                win = key
        out.append((0 if win is None else win[2],
                    -float("inf") if win is None else win[0], ny, rounds))
    w, best, ny, rounds = zip(*out)
    return (torch.tensor(w), torch.tensor(best, dtype=final.dtype),
            torch.tensor(ny), torch.tensor(rounds))


def _better(a, b):
    """The kernels' order on yielded options: higher score, then smaller
    window order (unique among the options of one step)."""
    return a[0] > b[0] or (a[0] == b[0] and a[1] < b[1])


def _replicate(tables, C):
    return [[t.clone() for t in tables] for _ in range(C)]


def _check_replicas(reps):
    for rep in reps[1:]:
        for a, b in zip(reps[0], rep):
            assert torch.equal(a, b), "replicas diverged"


def dense_cluster_model(const, init, batch, *, spread_alg, C, sub, K):
    """dense_scan as the cluster kernel computes it: the split walk's
    selection; the winner's usage committed once (its owning block), its
    spread and distinct_property values into each block's replica of the
    count tables. Returns (DenseOut, rounds (E, P))."""
    state = port_bp.NodeState(*(t.clone() for t in init))
    reps = _replicate((state.spread_counts, state.dp_counts), C)
    E, P = batch.ask_cpu.shape
    dt = const.cpu_cap.dtype
    has_cores = const.mhz_per_core.shape[-1] > 0
    chosen = torch.full((E, P), -1, dtype=torch.long)
    scores = torch.empty((E, P), dtype=dt)
    n_yielded = torch.empty((E, P), dtype=torch.long)
    rounds = torch.empty((E, P), dtype=torch.long)
    for i in range(P):
        b = dense._step_asks(batch, i, has_cores)
        # every block scores against its replica; they are equal
        scored = state._replace(spread_counts=reps[0][0],
                                dp_counts=reps[0][1])
        fit, final = dense._step_scores(const, scored, b, spread_alg)
        w, best, ny, rounds[:, i] = split_walk(
            final, fit, batch.limit[:, i], C, sub, K)
        do = batch.active[:, i] & (ny > 0)
        chosen[:, i] = torch.where(do, w, -1)
        scores[:, i] = torch.where(ny > 0, best,
                                   torch.tensor(-float("inf"), dtype=dt))
        n_yielded[:, i] = ny
        dense._commit_usage(const, state, b, w, do)
        dense._commit_devices(const, state, w, do)
        sp_v = dense._vidx_at(const.spread_vidx, w)
        dp_v = dense._vidx_at(const.dp_vidx, w)
        for sc, dpc in reps:
            dense._commit_counts(
                state._replace(spread_counts=sc, dp_counts=dpc), sp_v, dp_v,
                do)
        _check_replicas(reps)
    state = state._replace(spread_counts=reps[0][0], dp_counts=reps[0][1])
    return dense.DenseOut(chosen, scores, n_yielded, state), rounds


def preempt_cluster_model(const, init, batch, ptab, pinit, *, spread_alg,
                          C, sub):
    """dense_preempt as the cluster kernel computes it: the split walk's
    selection over the step's options (plain or preempting; the winner's
    eviction row and freed resources travel with it), the winner's node
    committed once, the count tables (spread, distinct_property and the
    group counts the search's max_parallel penalty reads) replicated per
    block. Returns (DensePreemptOut, rounds (E, P))."""
    state = port_bp.NodeState(*(t.clone() for t in init))
    evicted = pinit.evicted.clone()
    reps = _replicate((state.spread_counts, state.dp_counts, pinit.counts),
                      C)
    E, P = batch.ask_cpu.shape
    A = ptab.cpu.shape[2]
    dt = const.cpu_cap.dtype
    has_cores = const.mhz_per_core.shape[-1] > 0
    chosen = torch.full((E, P), -1, dtype=torch.long)
    scores = torch.empty((E, P), dtype=dt)
    n_yielded = torch.empty((E, P), dtype=torch.long)
    evict_rows = torch.zeros((E, P, A), dtype=torch.bool)
    rounds = torch.empty((E, P), dtype=torch.long)
    for i in range(P):
        b = dense._step_asks(batch, i, has_cores)
        sc0, dpc0, gc0 = reps[0]
        scored = state._replace(spread_counts=sc0, dp_counts=dpc0)
        step = preempt._preempt_step(const, scored, b, ptab, evicted, gc0,
                                     spread_alg)
        w, best, ny, rounds[:, i] = split_walk(
            step.final, step.fit, batch.limit[:, i], C, sub)
        any_yield = ny > 0
        do = batch.active[:, i] & any_yield
        chosen[:, i] = torch.where(do, w, -1)
        scores[:, i] = torch.where(any_yield, best,
                                   torch.tensor(-float("inf"), dtype=dt))
        n_yielded[:, i] = ny
        # the owning block's commit (with the first replica), then the
        # other blocks' replicas from the winner's record
        row = preempt._preempt_commit(
            const, state._replace(spread_counts=sc0, dp_counts=dpc0), b,
            ptab, evicted, gc0, step, w, do, any_yield)
        evict_rows[:, i] = row
        sp_v = dense._vidx_at(const.spread_vidx, w)
        dp_v = dense._vidx_at(const.dp_vidx, w)
        ar = torch.arange(E)
        grp_w = ptab.grp[ar, w].long()
        for sc, dpc, gc in reps[1:]:
            dense._commit_counts(
                state._replace(spread_counts=sc, dp_counts=dpc), sp_v, dp_v,
                do)
            for e, a in torch.nonzero(row & (grp_w >= 0)).tolist():
                gc[e, grp_w[e, a]] += 1
        _check_replicas(reps)
    state = state._replace(spread_counts=reps[0][0], dp_counts=reps[0][1])
    return preempt.DensePreemptOut(
        chosen, scores, n_yielded, evict_rows, state,
        port_bp.PreemptState(evicted, reps[0][2])), rounds


# --------------------------------------------------------------------------
# worlds

def _dense_lanes(seed, features, dtype_name, *, E=4, n=300, n_pad=320,
                 p=48, limits=(3, 14, 100, 2000)):
    rng = np.random.default_rng(seed)
    dicts = [chip_smoke.dense_fuzz_tables(
        np, rng, n=n, n_pad=n_pad, p=p, dtype=dtype_name,
        limit=int(limits[e % len(limits)]), features=features)
        for e in range(E)]
    trees = chip_smoke.dense_group(np, port_bp, dicts)
    return dense.lane_tensors(*trees, dtype_name=dtype_name,
                              device=torch.device("cpu"))


def _preempt_lanes(seed, features, dtype_name, *, E=2, n=40, n_pad=48,
                   p=10, A=8, limits=(3, 60)):
    rng = np.random.default_rng(seed)
    lanes = [list(chip_smoke.preempt_fuzz_tables(
        np, rng, n=n, n_pad=n_pad, p=p, dtype=dtype_name,
        limit=int(limits[e % len(limits)]), features=features, A=A, G=8))
        for e in range(E)]
    trees = chip_smoke.stack_preempt(np, port_bp, lanes)
    args, _ = dense.fused_tensors(trees, preempt.preempt_casts(dtype_name),
                                  device=torch.device("cpu"))
    return args


def _assert_same(got, want):
    for f, g, w in zip(got._fields, got, want):
        if isinstance(g, tuple):
            for sf, sg, sw in zip(g._fields, g, w):
                assert torch.equal(sg, sw), f"{f}.{sf} differs"
        else:
            assert torch.equal(g, w), f"{f} differs"
            if g.is_floating_point():
                # bit for bit, -0.0 and NaN payloads included
                assert torch.equal(g.view(torch.int64 if g.element_size()
                                          == 8 else torch.int32),
                                   w.view(torch.int64 if w.element_size()
                                          == 8 else torch.int32)), f


DENSE_WORLDS = {
    "spreads_skips": ("spreads", "low_score", "penalties"),
    "everything": ("targets", "dp", "devices", "cores", "ports", "distinct",
                   "affinity", "nonuniform"),
    "scarce": ("spreads", "dp", "scarce", "low_score"),
}


@pytest.mark.parametrize("dtype_name", DTYPES)
@pytest.mark.parametrize("C", CLUSTERS)
@pytest.mark.parametrize("world", sorted(DENSE_WORLDS))
def test_dense_cluster_model_matches_plain(world, C, dtype_name):
    const, init, batch = _dense_lanes(11, DENSE_WORLDS[world], dtype_name)
    want = dense.dense_scan_plain(const, init, batch, spread_alg=False)
    got, rounds = dense_cluster_model(const, init, batch, spread_alg=False,
                                      C=C, sub=8, K=2)
    _assert_same(got, want)
    full = -(-const.cpu_cap.shape[1] // (2 * C * 8))
    # the walk stopped early on the small limits and ran out on 2,000
    assert int(rounds.min()) < full and int(rounds.max()) == full


@pytest.mark.parametrize("dtype_name", DTYPES)
@pytest.mark.parametrize("C", CLUSTERS)
def test_dense_cluster_model_spread_algorithm(C, dtype_name):
    const, init, batch = _dense_lanes(5, ("spreads", "low_score"),
                                      dtype_name, E=2, limits=(14, 100))
    want = dense.dense_scan_plain(const, init, batch, spread_alg=True)
    got, _ = dense_cluster_model(const, init, batch, spread_alg=True, C=C,
                                 sub=32, K=1)
    _assert_same(got, want)


PREEMPT_WORLDS = {
    "tiers_maxp": ("tiers", "maxp", "penalties", "devices"),
    "scarce_distinct": ("scarce", "distinct", "affinity"),
}


@pytest.mark.parametrize("dtype_name", DTYPES)
@pytest.mark.parametrize("C", CLUSTERS)
@pytest.mark.parametrize("world", sorted(PREEMPT_WORLDS))
def test_preempt_cluster_model_matches_plain(world, C, dtype_name):
    args = _preempt_lanes(3, PREEMPT_WORLDS[world], dtype_name)
    want = preempt.dense_preempt_plain(*args, spread_alg=False)
    got, rounds = preempt_cluster_model(*args, spread_alg=False, C=C,
                                        sub=2)
    _assert_same(got, want)
    assert bool(want.evict_rows.any()) or world == "scarce_distinct"
    assert int(rounds.max()) <= -(-args[0].cpu_cap.shape[1] // (C * 2))


def test_split_walk_skip_fallback_and_limit_above_node_count():
    """Low scores early in the walk are skipped and, where the limit is
    never reached, come back as fallback in skip order after the counted
    options, whichever block holds them."""
    fit = torch.ones((1, 12), dtype=torch.bool)
    final = torch.tensor([[-1.0, 0.5, -2.0, 0.1, -0.5, 0.3,
                           -3.0, 0.2, 0.4, 0.6, 0.05, 0.7]])
    low = final <= SKIP_THRESHOLD
    for C, sub, K in ((1, 12, 1), (2, 3, 1), (4, 1, 2), (16, 1, 3)):
        for L in (2, 5, 100):
            w, best, ny, _ = split_walk(final, fit, torch.tensor([L]), C, sub,
                                        K)
            skip_rank = torch.cumsum(low.long(), dim=1)
            skipped = low & (skip_rank <= MAX_SKIP)
            cpos = torch.cumsum((fit & ~skipped).long(), dim=1)
            window = fit & ~skipped & (cpos <= L)
            n_counted = int((fit & ~skipped).sum())
            deficit = max(0, L - min(n_counted, L))
            want_ny = int(window.sum()) + min(deficit, int(skipped.sum()))
            assert int(ny[0]) == want_ny
            want_best = float(final[window].max())
            assert float(best[0]) == want_best
            assert float(final[0, int(w[0])]) == want_best
