"""The port's in-kernel wavefront (wave.solve_wavefront / wavefront_plain,
the plain version of csrc/wavefront.cu) against the JAX program it
replaces, nomad_tpu.solver.binpack.solve_wavefront (_solve_wavefront_impl),
on the tests/test_wavefront.py worlds and a numpy-seeded fuzz: several
lanes per port call, each held against the reference's single-lane
program; and a plain model of the card's route (the prep's tiled rank
walk, then the run-block or per-placement loop by each lane's penalty
gate) against the same program. Decisions (chosen, n_yielded) must
match exactly; scores within rtol 1e-12 in float64 and 1e-6 in float32
(the parity contract: the step evaluates the same IEEE operations in the
same order as XLA's lowering)."""
import random

import numpy as np
import pytest
import torch

from nomad_tpu.solver import binpack as ref
from test_wavefront import _world

from nomad_tpu_torch.solver import binpack as bp, wave

torch.set_num_threads(1)

RTOL = {"float64": 1e-12, "float32": 1e-6}


def _cast(tree, dt):
    return type(tree)(*(np.asarray(a).astype(dt)
                        if np.issubdtype(np.asarray(a).dtype, np.floating)
                        else np.asarray(a) for a in tree))


def _port(tree, cls):
    return cls(**{f: np.asarray(getattr(tree, f)) for f in cls._fields
                  if hasattr(tree, f)})


def _stack(trees):
    return type(trees[0])(*(np.stack(xs) for xs in zip(*trees)))


def _check_lanes(lanes, dtype_name, spread_alg=False):
    """lanes: [(const, init, batch)] of reference tables of one shape.
    One port call over all of them, each against the reference."""
    dt = np.dtype(dtype_name)
    lanes = [tuple(_cast(t, dt) for t in ln) for ln in lanes]
    port = [(_port(c, bp.NodeConst), _port(s, bp.NodeState),
             _port(b, bp.PlacementBatch)) for c, s, b in lanes]
    got = wave.solve_wavefront(*(_stack(list(x)) for x in zip(*port)),
                               spread_alg=spread_alg, dtype_name=dtype_name,
                               device="cpu")
    for e, (c, s, b) in enumerate(lanes):
        want = [np.asarray(x) for x in ref.solve_wavefront(
            c, s, b, spread_alg=spread_alg, dtype_name=dtype_name)]
        np.testing.assert_array_equal(got[0][e], want[0], err_msg=str(e))
        np.testing.assert_array_equal(got[2][e], want[2], err_msg=str(e))
        fin = np.isfinite(want[1])
        np.testing.assert_array_equal(np.isfinite(got[1][e]), fin)
        np.testing.assert_array_equal(got[1][e][~fin], want[1][~fin])
        np.testing.assert_allclose(got[1][e][fin], want[1][fin],
                                   rtol=RTOL[dtype_name])
    return got


def _worlds(seed0, k, **kw):
    out = []
    for s in range(k):
        rng = random.Random(seed0 + s)
        out.append(_world(rng, **kw))
    return out


WORLDS = {
    "plain": dict(n=40, p=30, limit=6),
    "distinct_tg": dict(n=50, p=35, distinct=True, limit=6),
    "distinct_job": dict(n=50, p=35, distinct=True, job_level=True,
                         limit=6),
    "ports": dict(n=40, p=30, n_dyn=7, has_static=True, limit=5),
    "affinity": dict(n=40, p=30, limit=6, affinity=True),
    "low_score": dict(n=30, p=40, low_score=True, count=1, limit=4),
    "exhaustion": dict(n=6, p=40, ask=(1500, 2048, 300), limit=3),
    "spreads_ignored": dict(n=40, p=30, limit=6, spreads=2),
}


@pytest.mark.parametrize("dtype_name", ["float64", "float32"])
@pytest.mark.parametrize("kind", sorted(WORLDS))
def test_wavefront_worlds_match_jax(kind, dtype_name):
    """Three worlds of each kind in one port call. The in-kernel
    wavefront carries no spread columns (S == 0), so a lane with spreads
    is solved as if it had none, by both."""
    lanes = _worlds(700 + 10 * sorted(WORLDS).index(kind), 3, **WORLDS[kind])
    _check_lanes(lanes, dtype_name)


@pytest.mark.parametrize("dtype_name", ["float64", "float32"])
def test_wavefront_spread_algorithm_matches_jax(dtype_name):
    _check_lanes(_worlds(100, 3, n=40, p=30, limit=6), dtype_name,
                 spread_alg=True)


@pytest.mark.parametrize("dtype_name", ["float64", "float32"])
def test_wavefront_penalties_and_inactive_tail_match_jax(dtype_name):
    lanes = []
    for s in range(3):
        rng = random.Random(900 + s)
        c, i, b = _world(rng, n=40, p=32, limit=6)
        pen = np.full(32, -1, dtype=np.int32)
        for pi in range(0, 32, 3):
            pen[pi] = rng.randrange(40)
        act = np.ones(32, dtype=bool)
        act[20 + s:] = False
        lanes.append((c, i, b._replace(penalty_idx=pen, active=act)))
    got = _check_lanes(lanes, dtype_name)
    assert (got[0][0][20:] == -1).all()


def _fuzz_lane(rng, n, p, dt):
    """A numpy-seeded uniform lane over every feature the in-kernel
    wavefront models: non-integer asks, ports, distinct_hosts, affinity,
    penalties, infeasible nodes and seeded usage."""
    cap = rng.choice([2000.0, 4000.0, 8000.0], n)
    mem = rng.choice([4096.0, 8192.0, 16384.0], n)
    used = rng.integers(0, 4, n) * rng.choice([250.0, 500.0, 1000.0], n)
    umem = rng.integers(0, 4, n) * rng.choice([256.0, 512.0, 1024.0], n)
    aff_on = bool(rng.random() < 0.5)
    const = ref.NodeConst(
        cpu_cap=cap.astype(dt), mem_cap=mem.astype(dt),
        disk_cap=np.full(n, 90 * 1024.0, dtype=dt),
        feasible=rng.random(n) > 0.15,
        affinity=np.where(rng.random(n) < 0.5,
                          rng.choice([-1.0, -0.5, 0.25, 0.5, 1.0], n),
                          0.0).astype(dt),
        has_affinity=np.asarray(aff_on),
        distinct_hosts=np.asarray(bool(rng.random() < 0.25)),
        distinct_job_level=np.asarray(bool(rng.random() < 0.5)),
        spread_vidx=np.zeros((0, n), dtype=np.int32),
        spread_desired=np.zeros((0, 1), dtype=dt),
        spread_has_targets=np.zeros(0, dtype=bool),
        spread_weights=np.zeros(0, dtype=dt),
        spread_sum_weights=np.asarray(0.0, dtype=dt),
        n_spreads=np.asarray(0, dtype=np.int32))
    placed = np.where(rng.random(n) < 0.2, rng.integers(1, 4, n), 0)
    init = ref.NodeState(
        used_cpu=used.astype(dt), used_mem=umem.astype(dt),
        used_disk=(rng.integers(0, 3, n) * 150.0).astype(dt),
        placed=placed.astype(np.int32),
        placed_job=(placed + rng.integers(0, 2, n)).astype(np.int32),
        static_free=rng.random(n) > 0.3,
        dyn_avail=rng.integers(-2, 40, n).astype(np.int32),
        spread_counts=np.zeros((0, 1), dtype=np.int32))
    ask = (float(rng.choice([99.5, 333.3, 500.0, 1500.25])),
           float(rng.choice([128.0, 511.7, 2048.0])), 300.0)
    pen = np.where(rng.random(p) < 0.3, rng.integers(0, n, p), -1)
    batch = ref.PlacementBatch(
        ask_cpu=np.full(p, ask[0], dtype=dt),
        ask_mem=np.full(p, ask[1], dtype=dt),
        ask_disk=np.full(p, ask[2], dtype=dt),
        n_dyn_ports=np.full(p, int(rng.choice([0, 0, 3, 9])),
                            dtype=np.int32),
        has_static=np.full(p, bool(rng.random() < 0.3)),
        limit=np.full(p, int(rng.choice([2, 4, 9, 28])), dtype=np.int32),
        count=np.full(p, int(rng.choice([1, 3, p])), dtype=np.int32),
        penalty_idx=pen.astype(np.int32),
        active=np.ones(p, dtype=bool))
    return const, init, batch


@pytest.mark.parametrize("dtype_name", ["float64", "float32"])
@pytest.mark.parametrize("n,p", [(25, 5), (80, 45), (64, 96)])
def test_wavefront_fuzz_matches_jax(n, p, dtype_name):
    """Four fuzz lanes per shape (P above N included: the compact table
    then runs past the fleet)."""
    rng = np.random.default_rng(4242 + n + p)
    dt = np.dtype(dtype_name)
    _check_lanes([_fuzz_lane(rng, n, p, dt) for _ in range(4)], dtype_name)


@pytest.mark.parametrize("dtype_name", ["float64", "float32"])
def test_wavefront_saturating_cast_matches_jax(dtype_name, monkeypatch):
    """A lane whose (cap - used0) / ask passes 2^31 with a positive ask on
    every third node: XLA's float -> int32 conversion saturates (a plain
    cast does not), and the +1 corrections then wrap past INT_MAX as int32
    adds do, so those nodes get no capacity at all. The port must give
    the reference's capacities; with a plain cast its tables differ."""
    rng = np.random.default_rng(99)
    dt = np.dtype(dtype_name)
    lanes = []
    for k in range(2):
        c, s, b = _fuzz_lane(rng, 30, 20, dt)
        big = np.where(np.arange(30) % 3 == k, 1e12, c.cpu_cap)
        lanes.append((c._replace(cpu_cap=big.astype(dt),
                                 feasible=np.ones(30, dtype=bool),
                                 distinct_hosts=np.asarray(False)),
                      s._replace(used_cpu=np.zeros(30, dtype=dt)),
                      b._replace(ask_cpu=np.full(20, 1e-3, dtype=dt),
                                 n_dyn_ports=np.zeros(20, dtype=np.int32),
                                 has_static=np.zeros(20, dtype=bool))))
    assert np.float64(1e12) / np.float64(dt.type(1e-3)) > 2 ** 31
    _check_lanes(lanes, dtype_name)
    c, s, b = lanes[0]
    trees = [type(t)(*(torch.from_numpy(np.asarray(a)[None].copy())
                       for a in t))
             for t in (_port(c, bp.NodeConst), _port(s, bp.NodeState),
                       _port(b, bp.PlacementBatch))]
    sat = wave.wavefront_tables(*trees)[0]
    assert not (sat[0, :, 7] % 3 == 0).logical_and(sat[0, :, 0] > 0).any()
    monkeypatch.setattr(wave, "_sat_i32", lambda q: q.to(torch.int32))
    assert not torch.equal(wave.wavefront_tables(*trees)[0], sat)


def test_wavefront_tables_saturate_like_xla():
    """The capacity fold's float -> int32 step on its own: NaN gives 0 and
    out-of-range values saturate, in both dtypes."""
    for dt in (torch.float32, torch.float64):
        q = torch.tensor([1e12, -1e12, float("nan"), float("inf"),
                          -float("inf"), 7.0], dtype=dt)
        assert wave._sat_i32(q).tolist() == [
            2 ** 31 - 1, -2 ** 31, 0, 2 ** 31 - 1, -2 ** 31, 7]


def test_wavefront_wrapper_takes_plain_only_on_cpu():
    """The wrapper checks its tensors and raises for an unsupported device
    rather than running anything else."""
    rng = np.random.default_rng(5)
    c, s, b = _fuzz_lane(rng, 16, 8, np.dtype("float64"))
    trees = [_port(t, cls) for t, cls in ((c, bp.NodeConst),
                                         (s, bp.NodeState),
                                         (b, bp.PlacementBatch))]
    stacked = [type(t)(*(torch.from_numpy(np.asarray(a)[None].copy())
                         for a in t)) for t in trees]
    bad = stacked[0]._replace(cpu_cap=stacked[0].cpu_cap.float())
    with pytest.raises(TypeError):
        wave.wavefront(bad, *stacked[1:], spread_alg=False)
    out = wave.wavefront(*stacked, spread_alg=False)
    want = wave.wavefront_plain(*stacked, spread_alg=False)
    for x, y in zip(out, want):
        assert torch.equal(x, y)


def _single_node_lanes(dt, E, P, seed):
    """E one-node lanes whose cpu cap sits one ulp beside used0 + m * ask:
    a lane places exactly its node's capacity, so the count of placements
    reads the capacity predicate, and a rounded multiply then add
    disagrees with a fused one on many of them."""
    rng = np.random.default_rng(seed)
    ask = rng.choice([0.1, 0.3, 0.7, 1.3, 2.9], E).astype(dt)
    used = (rng.integers(0, 50, E) * dt.type(0.3)).astype(dt)
    m = rng.integers(1, 30, E).astype(dt)
    base = (used + (m * ask).astype(dt)).astype(dt)
    exact = np.array([float(np.longdouble(a) * np.longdouble(b)
                            + np.longdouble(c))
                      for a, b, c in zip(m, ask, used)])
    cap = np.where(exact < base, np.nextafter(base, dt.type(-np.inf)),
                   np.where(exact > base,
                            np.nextafter(base, dt.type(np.inf)),
                            base)).astype(dt)
    col = lambda a: np.asarray(a)[:, None]   # noqa: E731
    const = ref.NodeConst(
        cpu_cap=col(cap), mem_cap=np.full((E, 1), 1e9, dt),
        disk_cap=np.full((E, 1), 1e9, dt), feasible=np.ones((E, 1), bool),
        affinity=np.zeros((E, 1), dt), has_affinity=np.zeros(E, bool),
        distinct_hosts=np.zeros(E, bool),
        distinct_job_level=np.zeros(E, bool),
        spread_vidx=np.zeros((E, 0, 1), np.int32),
        spread_desired=np.zeros((E, 0, 1), dt),
        spread_has_targets=np.zeros((E, 0), bool),
        spread_weights=np.zeros((E, 0), dt),
        spread_sum_weights=np.zeros(E, dt), n_spreads=np.zeros(E, np.int32),
        dp_vidx=np.zeros((E, 0, 1), np.int32),
        dp_limit=np.zeros((E, 0), np.int32),
        dp_tg_scope=np.zeros((E, 0), bool),
        dev_aff=np.zeros((E, 0, 0, 1), dt),
        dev_count=np.zeros((E, 0), np.int32),
        dev_sum_weight=np.zeros(E, np.float32),
        mhz_per_core=np.zeros((E, 0), dt))
    init = ref.NodeState(
        used_cpu=col(used), used_mem=np.zeros((E, 1), dt),
        used_disk=np.zeros((E, 1), dt), placed=np.zeros((E, 1), np.int32),
        placed_job=np.zeros((E, 1), np.int32),
        static_free=np.ones((E, 1), bool),
        dyn_avail=np.full((E, 1), 100, np.int32),
        spread_counts=np.zeros((E, 0, 1), np.int32),
        dp_counts=np.zeros((E, 0, 0), np.int32),
        dev_free=np.zeros((E, 0, 0, 1), np.int32),
        cores_free=np.zeros((E, 0), np.int32))
    batch = ref.PlacementBatch(
        ask_cpu=np.repeat(col(ask), P, 1), ask_mem=np.ones((E, P), dt),
        ask_disk=np.ones((E, P), dt),
        n_dyn_ports=np.zeros((E, P), np.int32),
        has_static=np.zeros((E, P), bool),
        limit=np.ones((E, P), np.int32), count=np.full((E, P), P, np.int32),
        penalty_idx=np.full((E, P), -1, np.int32),
        active=np.ones((E, P), bool), ask_cores=np.zeros((E, 0), np.int32))
    unfused = np.array([
        max([k for k in range(P + 1)
             if dt.type(dt.type(dt.type(k) * a) + u) <= c] + [0])
        for a, u, c in zip(ask, used, cap)])
    return const, init, batch, unfused


@pytest.mark.parametrize("dtype_name", ["float64", "float32"])
def test_wavefront_capacity_predicate_is_one_fma(dtype_name):
    """XLA fuses the capacity predicate's used0 + m * ask into one fma (a
    bit probe of the reference: one-node lanes straddling the cap by an
    ulp); the port's capacities equal the reference's, and differ from a
    rounded multiply then add on some lanes, so the probe has teeth."""
    import functools

    import jax
    dt = np.dtype(dtype_name)
    E, P = 400, 40
    const, init, batch, unfused = _single_node_lanes(dt, E, P, seed=3)
    fn = jax.jit(jax.vmap(functools.partial(ref._solve_wavefront_impl,
                                            dtype_name=dtype_name)))
    want = [np.asarray(x) for x in fn(const, init, batch)]
    got = wave.solve_wavefront(
        _port(const, bp.NodeConst), _port(init, bp.NodeState),
        _port(batch, bp.PlacementBatch), dtype_name=dtype_name,
        device="cpu")
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[2], want[2])
    placed = (want[0] >= 0).sum(axis=1)
    assert (placed != np.minimum(unfused, P)).any()


# --------------------------------------------------------------------------
# chip_smoke's bound of the kernel

def _bound_of(const, init, batch, dtype_name="float64"):
    """One reference lane through the fused transport onto the CPU, its
    wavefront output, chip_smoke's bound of it and the whole input
    tables' bytes."""
    import chip_smoke
    from nomad_tpu_torch.solver import dense
    trees = tuple(_stack([_port(t, cls)]) for t, cls in (
        (const, bp.NodeConst), (init, bp.NodeState),
        (batch, bp.PlacementBatch)))
    ten, _ = dense.fused_tensors(trees, (dense.lane_casts(dtype_name),) * 3,
                                 device=torch.device("cpu"))
    out = wave.wavefront(*ten, spread_alg=False)
    bnd = chip_smoke.wavefront_bound(np, wave, ten, out, dtype_name)
    return out, bnd[2], sum(t.nbytes for tree in ten for t in tree)


def _pad_nodes(tree, n, n_to):
    """``tree`` with every axis of size ``n`` zero-padded to ``n_to`` (the
    added nodes infeasible, with no capacity)."""
    def pad(a):
        a = np.asarray(a)
        widths = [(0, n_to - n if d == n else 0) for d in a.shape]
        return np.pad(a, widths) if a.ndim else a
    return type(tree)(*(pad(a) for a in tree))


def test_wavefront_bound_counts_rows_up_to_the_last_choice():
    """The bound counts each lane's node rows up to the last node chosen,
    not whole tables and not the kernel's own compact table: padding the
    node axis eightfold changes no decision and leaves the bytes as they
    were, while the whole tables grow."""
    c, s, b = _world(random.Random(5), n=40, p=10, limit=6)
    outs, nbytes, whole = [], [], []
    for n_to in (40, 320):
        out, nb, wh = _bound_of(*(_pad_nodes(t, 40, n_to) for t in (c, s, b)))
        outs.append(out)
        nbytes.append(nb)
        whole.append(wh)
    assert bool((outs[0][2] == 6).all())       # no step yielded short
    for x, y in zip(outs[0], outs[1]):
        assert torch.equal(x, y)
    assert nbytes[0] == nbytes[1] < whole[0]
    assert whole[1] > 5 * whole[0]


def test_wavefront_bound_counts_flagged_tables_only_with_their_flag():
    """dyn_avail counts only where the lanes ask dynamic ports, placed_job
    only under distinct_hosts at job level: one 4-byte entry per node row
    reached, with the decisions unchanged."""
    c, s, b = _world(random.Random(6), n=40, p=10, limit=6)
    base, nb0, _ = _bound_of(c, s, b)
    reach = int(base[0].max()) + 1
    ports = _bound_of(c, s._replace(dyn_avail=np.full(40, 1000, np.int32)),
                      b._replace(n_dyn_ports=np.ones(10, np.int32)))
    job_only = _bound_of(c._replace(distinct_job_level=np.asarray(True)),
                         s, b)
    assert torch.equal(ports[0][0], base[0])
    assert ports[1] == nb0 + 4 * reach
    assert torch.equal(job_only[0][0], base[0]) and job_only[1] == nb0
    c_dh = c._replace(distinct_hosts=np.asarray(True))
    s_dh = s._replace(placed_job=np.asarray(s.placed))
    tg, nb_tg, _ = _bound_of(c_dh, s_dh, b)
    jl, nb_jl, _ = _bound_of(
        c_dh._replace(distinct_job_level=np.asarray(True)), s_dh, b)
    assert torch.equal(tg[0], jl[0])
    assert nb_jl == nb_tg + 4 * (int(tg[0].max()) + 1)


# --------------------------------------------------------------------------
# The card's route (csrc/wavefront.cu), modelled on the CPU: the prep's
# tiled rank walk builds the compact table, then each lane takes the
# run-block loop when none of its P penalty entries is set, else the
# per-placement loop; both held against the reference.

def _row(const, init, c, aff, e, n, cap, pos):
    return torch.stack([
        torch.as_tensor(cap, dtype=const.cpu_cap.dtype),
        init.used_cpu[e, n], init.used_mem[e, n], const.cpu_cap[e, n],
        const.mem_cap[e, n], init.placed[e, n].to(const.cpu_cap.dtype),
        aff[e, n], torch.as_tensor(pos, dtype=const.cpu_cap.dtype)])


def _tiled_compact(const, init, c, aff, C, tile, cluster):
    """The prep's walk over each lane's nodes: rounds of ``cluster`` tiles
    of ``tile`` nodes; each tile's count of fit nodes (c > 0), their
    exclusive prefix over the round's tiles after the count before the
    round, and in-tile ranks in node order; fit nodes ranked below C
    write their rows, a tile whose first rank reaches C writes none, and
    the walk ends with the round whose running count reaches C. Rows past
    the last fit node repeat node N-1's row with c = 0 and pos = N.
    Returns the compact table and the rounds walked per lane."""
    E, N = c.shape
    compact = torch.full((E, C, 8), float("nan"),
                         dtype=const.cpu_cap.dtype)
    rounds = []
    for e in range(E):
        offset = base = walked = 0
        while base < N and offset < C:
            tiles = [(lo, c[e, lo:min(lo + tile, N)] > 0)
                     for lo in range(base, base + cluster * tile, tile)]
            counts = [int(fit.sum()) for _, fit in tiles]
            prefix = offset
            for (lo, fit), cnt in zip(tiles, counts):
                if prefix < C:
                    ranks = prefix + torch.cumsum(fit.long(), 0) - 1
                    for j in torch.nonzero(fit & (ranks < C)).flatten():
                        n = lo + int(j)
                        compact[e, int(ranks[j])] = _row(
                            const, init, c, aff, e, n, int(c[e, n]), n)
                prefix += cnt
            offset += sum(counts)
            base += cluster * tile
            walked += 1
        for k in range(offset, C):
            compact[e, k] = _row(const, init, c, aff, e, N - 1, 0, N)
        rounds.append(walked)
    return compact, rounds


def _model_route(const, init, batch, tile, cluster, spread_alg=False):
    """The card's route in plain PyTorch: wavefront_caps, the tiled walk
    (its table equal to wavefront_tables'), then per lane by the all-P
    penalty gate wave_block_plain or wave_compact_plain."""
    E, N = const.cpu_cap.shape
    P = batch.ask_cpu.shape[1]
    C = P + bp.WAVE_B
    dt = const.cpu_cap.dtype
    c, aff = wave.wavefront_caps(const, init, batch)
    compact, rounds = _tiled_compact(const, init, c, aff, C, tile, cluster)
    assert torch.equal(compact, wave.wavefront_tables(const, init,
                                                      batch)[0])
    scal_f = torch.stack([batch.ask_cpu[:, 0], batch.ask_mem[:, 0],
                          batch.count[:, 0].to(dt)], dim=1)
    scal_i = torch.stack([batch.limit[:, 0].to(torch.int32),
                          batch.active.sum(dim=1).to(torch.int32)], dim=1)
    pen = batch.penalty_idx.to(torch.int32)
    block = (pen < 0).all(dim=1)
    out, routes = [], []
    for e in range(E):
        args = (compact[e:e + 1], scal_f[e:e + 1], scal_i[e:e + 1])
        if bool(block[e]):
            out.append(wave.wave_block_plain(*args, spread_alg=spread_alg,
                                             B=bp.WAVE_B))
        else:
            sp = bp.WaveSpread(
                counts=torch.zeros((1, 0, 1), dtype=torch.int32),
                desired=torch.zeros((1, 0, 1), dtype=dt),
                has_targets=torch.zeros((1, 0), dtype=torch.bool),
                weights=torch.zeros((1, 0), dtype=dt),
                sum_weights=torch.zeros(1, dtype=dt))
            out.append(wave.wave_compact_plain(
                *args, pen[e:e + 1], sp, spread_alg=spread_alg,
                B=bp.WAVE_B))
        routes.append("block" if bool(block[e]) else "compact")
    got = tuple(torch.cat([o[i] for o in out]) for i in range(3))
    return got, routes, rounds


def _check_model(lanes, dtype_name, tile, cluster):
    """The model over all ``lanes`` (reference tables of one shape) in one
    group, each lane against the reference's single-lane program."""
    from nomad_tpu_torch.solver import dense
    dt = np.dtype(dtype_name)
    lanes = [tuple(_cast(t, dt) for t in ln) for ln in lanes]
    trees = tuple(_stack([_port(ln[k], cls) for ln in lanes])
                  for k, cls in enumerate((bp.NodeConst, bp.NodeState,
                                           bp.PlacementBatch)))
    ten, _ = dense.fused_tensors(trees, (dense.lane_casts(dtype_name),) * 3,
                                 device=torch.device("cpu"))
    got, routes, rounds = _model_route(*ten, tile, cluster)
    for e, (c, s, b) in enumerate(lanes):
        want = [np.asarray(x) for x in ref.solve_wavefront(
            c, s, b, spread_alg=False, dtype_name=dtype_name)]
        np.testing.assert_array_equal(got[0][e].numpy(), want[0],
                                      err_msg=str(e))
        np.testing.assert_array_equal(got[2][e].numpy(), want[2],
                                      err_msg=str(e))
        g = got[1][e].numpy()
        fin = np.isfinite(want[1])
        np.testing.assert_array_equal(np.isfinite(g), fin)
        np.testing.assert_array_equal(g[~fin], want[1][~fin])
        np.testing.assert_allclose(g[fin], want[1][fin],
                                   rtol=RTOL[dtype_name])
    return routes, rounds


def _no_penalty(lane):
    c, s, b = lane
    return c, s, b._replace(penalty_idx=np.full_like(b.penalty_idx, -1))


def _late_penalty(lane, n_active, at):
    """``lane`` active for its first n_active placements, with one
    penalty, at placement ``at`` past them."""
    c, s, b = _no_penalty(lane)
    act = np.arange(b.active.shape[0]) < n_active
    pen = np.full_like(b.penalty_idx, -1)
    pen[at] = 3
    return c, s, b._replace(active=act, penalty_idx=pen)


TILINGS = [(7, 3), (16, 2), (256, 8)]             # (256, 8): the card's


@pytest.mark.parametrize("dtype_name", ["float64", "float32"])
@pytest.mark.parametrize("tile,cluster", TILINGS)
def test_card_route_mixed_group_matches_jax(tile, cluster, dtype_name):
    """Penalty-free lanes (run-block), fuzz lanes with penalties and a
    lane whose only penalty lies past n_active (per-placement: the gate
    reads all P entries) in one group; tiles that do not divide N."""
    rng = np.random.default_rng(77)
    dt = np.dtype(dtype_name)
    fuzz = [_fuzz_lane(rng, 80, 45, dt) for _ in range(4)]
    lanes = [_no_penalty(fuzz[0]), _no_penalty(fuzz[1]), fuzz[2], fuzz[3],
             _late_penalty(fuzz[0], 20, 30)]
    routes, _ = _check_model(lanes, dtype_name, tile, cluster)
    assert routes == ["block", "block", "compact", "compact", "compact"]


def _edge_world(kind, rng, dt):
    if kind == "n_below_c":                        # P > N: C = 72 > 25
        return [_fuzz_lane(rng, 25, 40, dt) for _ in range(3)]
    lanes = [_fuzz_lane(rng, 40, 30, dt) for _ in range(3)]
    if kind == "no_fit":
        return [(c._replace(feasible=np.zeros(40, dtype=bool)), s, b)
                for c, s, b in lanes]
    if kind == "all_fit":
        return [_no_penalty((
            c._replace(feasible=np.ones(200, dtype=bool),
                       distinct_hosts=np.asarray(False)),
            s._replace(used_cpu=np.zeros(200, dtype=dt),
                       used_mem=np.zeros(200, dtype=dt)),
            b._replace(n_dyn_ports=np.zeros(30, dtype=np.int32),
                       has_static=np.zeros(30, dtype=bool))))
            for c, s, b in (_fuzz_lane(rng, 200, 30, dt) for _ in range(3))]
    # the saturating cast: (cap - used0) / ask past 2^31 on every third
    # node, as test_wavefront_saturating_cast_matches_jax builds it
    out = []
    for k, (c, s, b) in enumerate(lanes[:2]):
        big = np.where(np.arange(40) % 3 == k, 1e12, c.cpu_cap)
        out.append((c._replace(cpu_cap=big.astype(dt),
                               feasible=np.ones(40, dtype=bool),
                               distinct_hosts=np.asarray(False)),
                    s._replace(used_cpu=np.zeros(40, dtype=dt)),
                    b._replace(ask_cpu=np.full(30, 1e-3, dtype=dt),
                               n_dyn_ports=np.zeros(30, dtype=np.int32),
                               has_static=np.zeros(30, dtype=bool))))
    return out + [_no_penalty(out[0])]


@pytest.mark.parametrize("dtype_name", ["float64", "float32"])
@pytest.mark.parametrize("kind", ["n_below_c", "no_fit", "all_fit",
                                  "saturating_cast"])
def test_card_route_edges_match_jax(kind, dtype_name):
    """The walk's edges: N below C (rows past the fleet), no fit node (the
    walk covers N, every row a repeat of node N-1), every node fit (200
    nodes: the walk stops at the round that reaches C = 62) and XLA's
    saturating cast; tiles of 7 in clusters of 3 (neither divides N)."""
    rng = np.random.default_rng(31 + len(kind))
    lanes = _edge_world(kind, rng, np.dtype(dtype_name))
    routes, rounds = _check_model(lanes, dtype_name, 7, 3)
    if kind == "all_fit":
        assert routes == ["block"] * 3
        assert rounds == [3] * 3                   # 63 fit nodes >= C
    if kind == "no_fit":
        assert rounds == [2] * 3                   # 2 x 21 nodes >= N
