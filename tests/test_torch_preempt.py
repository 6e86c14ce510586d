"""The port's preemption path against the JAX programs it replaces.

nomad_tpu_torch.solver.preempt (the plain PyTorch versions, which the CPU
wrappers run) and the numpy host halves in nomad_tpu_torch.solver.binpack
must reproduce nomad_tpu/solver/binpack.py on the same inputs, run on the
CPU as the reference's own tests run it:

  * the eviction search (_preempt_search_core) in its while-loop and
    fixed A-round forms: met, evict, freed and net priority to the bit;
  * _numpy_preempt_pristine, wavefront_preempt_compact_host and
    _wave_device_capacity array for array;
  * dense preemption (solve_placements_preempt) and windowed preemption
    (solve_lane_wave_preempt): chosen, n_yielded, eviction rows and the
    final state exactly, scores within rtol=1e-12 (float64) and 1e-6
    (float32). The port evaluates the same IEEE operations in the same
    order as XLA's CPU lowering -- the distance's sum of squares as two
    fused multiply-adds, XLA's own exp expansion -- so scores are
    expected to agree to the bit, and the tests assert that too.

Worlds: tests/test_wavefront_preempt.py's own generator (random,
max_parallel, distinct_hosts, affinity + penalty, saturation, batched
with inert padding), and chip_smoke.preempt_fuzz_tables, the generator
chip_smoke.py feeds the kernels on the card (priority tiers with
ineligible candidates, shared max_parallel groups, job-level
distinct_hosts, GPU capacity, inert lanes).
"""
import functools
import random
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from nomad_tpu.solver import binpack as ref
from test_wavefront_preempt import _world

from nomad_tpu_torch import kernels
from nomad_tpu_torch.solver import binpack as port_bp
from nomad_tpu_torch.solver import preempt, scoring

# One intra-op thread: the port's CPU tensors are small, and the test
# run already keeps one xdist worker busy per core.
torch.set_num_threads(1)

RTOL = {"float64": 1e-12, "float32": 1e-6}
DTYPES = ("float64", "float32")
TREES = ("NodeConst", "NodeState", "PlacementBatch", "PreemptTables",
         "PreemptState")


def _cast(tree, dtype_name):
    return type(tree)(*(np.asarray(a).astype(dtype_name)
                        if np.issubdtype(np.asarray(a).dtype, np.floating)
                        else np.asarray(a) for a in tree))


def _lane(trees, dtype_name):
    """A lane's five tables as (reference tuples, port tuples), floating
    fields in ``dtype_name``; ``trees`` are reference tuples or dicts."""
    out_ref, out_port = [], []
    for name, t in zip(TREES, trees):
        fields = t if isinstance(t, dict) else t._asdict()
        for mod, out in ((ref, out_ref), (port_bp, out_port)):
            cls = getattr(mod, name)
            out.append(_cast(cls(**{f: fields[f] for f in cls._fields
                                    if f in fields}), dtype_name))
    return tuple(out_ref), tuple(out_port)


def _stack(lanes):
    return tuple(type(ts[0])(*(np.stack([np.asarray(f) for f in fields])
                               for fields in zip(*ts)))
                 for ts in zip(*lanes))


def _fuzz(seed, features, dtype_name, *, n=48, n_pad=64, p=12, limit=5,
          A=8, n_active=None):
    rng = np.random.default_rng(seed)
    return _lane(chip_smoke.preempt_fuzz_tables(
        np, rng, n=n, n_pad=n_pad, p=p, dtype=dtype_name, limit=limit,
        features=features, A=A, G=8, n_active=n_active), dtype_name)


# --------------------------------------------------------------------------
# the eviction search

def _search_case(seed, dt):
    rng = np.random.default_rng(seed)
    n, A, G = 64, int(rng.choice([4, 8, 16])), 6
    used_c = rng.choice([0.0, 250.0, 500.0, 700.0, 900.0, 1000.0],
                        (n, A)).astype(dt)
    used_m = rng.choice([0.0, 128.0, 512.0, 1024.0], (n, A)).astype(dt)
    used_d = rng.choice([0.0, 150.0, 300.0], (n, A)).astype(dt)
    prio = rng.choice([10, 20, 30, 40, 65, 80], (n, A)).astype(np.int32)
    maxp = np.where(rng.random((n, A)) < 0.4, rng.integers(1, 3, (n, A)),
                    0).astype(np.int32)
    grp = np.where(rng.random((n, A)) < 0.9, rng.integers(0, G, (n, A)),
                   -1).astype(np.int32)
    valid_now = (rng.random((n, A)) < 0.8) & (rng.random((n, A)) > 0.1)
    eligible = valid_now & (70 - prio >= 10)
    caps = [rng.choice([2000.0, 4000.0, 8000.0], n).astype(dt),
            rng.choice([4096.0, 8192.0], n).astype(dt),
            np.full(n, 20000.0, dtype=dt)]
    counts = rng.integers(0, 3, G).astype(np.int32)
    ask = [rng.choice([500.0, 1000.0, 1500.0]), rng.choice([256.0, 512.0]),
           rng.choice([0.0, 150.0])]
    return (used_c, used_m, used_d, prio, maxp, grp, valid_now, eligible,
            *caps, counts, *(dt(a) for a in ask))


@functools.lru_cache(maxsize=None)
def _ref_search(dtype_name, static_iters):
    return jax.jit(partial(ref._preempt_search_core,
                           dtype=jnp.dtype(dtype_name),
                           static_iters=static_iters))


@pytest.mark.parametrize("static_iters", [False, True],
                         ids=["while", "fixed"])
@pytest.mark.parametrize("dtype_name", DTYPES)
@pytest.mark.parametrize("seed", range(6))
def test_search_matches_jax(seed, dtype_name, static_iters):
    """met, evict, freed and net priority to the bit, in both forms of
    the greedy loop."""
    args = _search_case(seed, np.dtype(dtype_name).type)
    want = _ref_search(dtype_name, static_iters)(*args)
    got = preempt.preempt_search_plain(
        *(torch.from_numpy(a) if isinstance(a, np.ndarray) else float(a)
          for a in args), static_iters=static_iters)
    for name, w, g in zip(preempt.SearchOut._fields, want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    assert bool(np.asarray(want[0]).any()) and bool(np.asarray(want[1]).any())


def test_distance_exp_and_preemption_score_match_xla():
    """The three scalar expressions the preemption score adds, to the bit
    over many inputs: the distance (XLA contracts its sum of squares into
    two fused multiply-adds), exp (XLA's own expansion, not libm's) and
    the logistic preemption score on net priority."""
    rng = np.random.default_rng(11)
    for dt in (np.float64, np.float32):
        n = 4000
        need = [rng.choice([1500.0, 1000.0, 500.0, 0.0, -200.0], n).astype(dt)
                for _ in range(3)]
        used = [rng.choice([250.0, 500.0, 700.0, 900.0, 1024.0], n).astype(dt)
                for _ in range(3)]
        want = np.asarray(jax.jit(ref._distance)(*need, *used))
        got = scoring._distance(*(torch.from_numpy(a) for a in need + used))
        np.testing.assert_array_equal(got.numpy(), want)
        x = np.concatenate([rng.uniform(-12, -8, n),
                            rng.uniform(-80, 80, n)]).astype(dt)
        np.testing.assert_array_equal(scoring._exp(torch.from_numpy(x)).numpy(),
                                      np.asarray(jax.jit(jnp.exp)(x)))
        net = rng.uniform(0, 200, n).astype(dt)

        def pscore(v):
            return 1.0 / (1.0 + jnp.exp(ref.PREEMPT_SCORE_RATE
                                        * (v - ref.PREEMPT_SCORE_ORIGIN)))

        np.testing.assert_array_equal(
            scoring._preempt_score(torch.from_numpy(net)).numpy(),
            np.asarray(jax.jit(pscore)(net)))


# --------------------------------------------------------------------------
# the numpy host halves

@pytest.mark.parametrize("dtype_name", DTYPES)
@pytest.mark.parametrize("seed", range(3))
def test_numpy_pristine_matches_reference(seed, dtype_name):
    args = _search_case(seed, np.dtype(dtype_name).type)
    (used_c, used_m, used_d, prio, maxp, grp, valid, _, cc, cm, cd, counts,
     ac, am, ad) = args
    call = (used_c, used_m, used_d, prio, maxp, grp, valid, counts, cc, cm,
            cd, 70, ac, am, ad)
    want = ref._numpy_preempt_pristine(*call)
    got = port_bp._numpy_preempt_pristine(*call)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


FEATURE_SETS = (
    ("tiers",), ("maxp",), ("distinct", "affinity"),
    ("job_level", "penalties"), ("scarce",), ("devices",),
    ("tiers", "maxp", "penalties", "devices"), ("inert",))


@pytest.mark.parametrize("dtype_name", DTYPES)
@pytest.mark.parametrize("features", FEATURE_SETS, ids="-".join)
def test_wavefront_preempt_compact_host_matches_reference(features,
                                                           dtype_name):
    (rc, ri, rb, rp, rs), (pc, pi, pb, pp_, ps) = _fuzz(
        7, features, dtype_name, p=20)
    want = ref.wavefront_preempt_compact_host(rc, ri, rb, rp, rs,
                                              dtype_name, p_pad=32, B=32)
    got = port_bp.wavefront_preempt_compact_host(pc, pi, pb, pp_, ps,
                                                 dtype_name, p_pad=32, B=32)
    assert set(got[1]) == set(want[1]) == set(port_bp.WPC_CAND)
    for k in port_bp.WPC_CAND:
        np.testing.assert_array_equal(got[1][k], want[1][k], err_msg=k)
        assert got[1][k].dtype == want[1][k].dtype
    for i in (0, 2, 3, 4, 5):
        np.testing.assert_array_equal(got[i], want[i], err_msg=str(i))
        assert got[i].dtype == want[i].dtype, i


@pytest.mark.parametrize("seed", range(4))
def test_wave_device_capacity_matches_reference(seed):
    """The device-dimension capacity replay, bounded and unbounded (a
    request of count 0 never drains), and the compact host table of a
    uniform device lane, which folds it in."""
    rng = np.random.default_rng(seed)
    n, R, Gd = 40, 1 + seed % 2, 2
    free = np.where(rng.random((R, Gd, n)) < 0.6,
                    rng.integers(0, 5, (R, Gd, n)), -1).astype(np.int32)
    aff = rng.choice([0.0, 10.0, 50.0], (R, Gd, n))
    count = rng.integers(1, 3, R).astype(np.int32)
    for cnt in (count, np.zeros(R, dtype=np.int32)):
        rconst = ref.NodeConst(*([None] * 14), dev_aff=aff, dev_count=cnt)
        rinit = ref.NodeState(*([None] * 8), dev_free=free)
        want = ref._wave_device_capacity(rconst, rinit)
        got = port_bp._wave_device_capacity(rconst, rinit)
        if want is None:
            assert got is None
        else:
            np.testing.assert_array_equal(got, want)
    lane = chip_smoke.dense_fuzz_tables(
        np, rng, n=n - 8, n_pad=n, p=16, dtype="float64", limit=5,
        features=("devices",))
    lane[0].update(dev_aff=np.zeros_like(lane[0]["dev_aff"]),
                   dev_sum_weight=np.asarray(0.0))
    (rc, ri, rb, *_), (pc, pi, pb, *_) = _lane(
        lane + (chip_smoke.preempt_fuzz_tables(
            np, rng, n=n - 8, n_pad=n, p=16, dtype="float64",
            limit=5)[3:]), "float64")
    want = ref.wavefront_compact_host(rc, ri, rb, "float64", p_pad=32, B=32)
    got = port_bp.wavefront_compact_host(pc, pi, pb, "float64", p_pad=32,
                                         B=32)
    for i in range(4):
        np.testing.assert_array_equal(got[i], want[i], err_msg=str(i))


# --------------------------------------------------------------------------
# dense and windowed preemption

def _assert_out_equal(want, got, dtype_name, *, state=True):
    """Reference (chosen, scores, n_yielded, evict_rows[, state]) against
    the port's, decisions, eviction rows and state exactly, scores to the
    bit (and within the stated rtol)."""
    ch, sc, ny, ev = (np.asarray(x) for x in want[:4])
    np.testing.assert_array_equal(np.asarray(got[0]), ch)
    np.testing.assert_array_equal(np.asarray(got[2]), ny)
    np.testing.assert_array_equal(np.asarray(got[3]), ev)
    g = np.asarray(got[1])
    np.testing.assert_allclose(g, sc, rtol=RTOL[dtype_name])
    np.testing.assert_array_equal(g, sc)
    if state:
        for name in port_bp.NodeState._fields:
            np.testing.assert_array_equal(
                np.asarray(getattr(got[4], name)),
                np.asarray(getattr(want[4], name)), err_msg=name)


def _port_dense(lanes, dtype_name):
    out = preempt.solve_placements_preempt(
        *_stack(lanes), spread_alg=False, dtype_name=dtype_name,
        device="cpu")
    return out


def _check_dense(rlane, plane, dtype_name):
    want = ref.solve_placements_preempt(*rlane, spread_alg=False,
                                        dtype_name=dtype_name)
    out = _port_dense([plane], dtype_name)
    _assert_out_equal(want, (out.chosen[0], out.scores[0],
                             out.n_yielded[0], out.evict_rows[0],
                             type(out.state)(*(t[0] for t in out.state))),
                      dtype_name)
    return out


def _check_wave(rlane, plane, dtype_name):
    want = ref.solve_lane_wave_preempt(*rlane, spread_alg=False,
                                       dtype_name=dtype_name)
    got = preempt.solve_lane_wave_preempt(
        *_stack([plane]), spread_alg=False, dtype_name=dtype_name,
        device="cpu")
    _assert_out_equal(want, [g[0] for g in got], dtype_name, state=False)
    return got


WORLDS = {
    # tests/test_wavefront_preempt.py's worlds, seed for seed
    "random": (3000, dict(n=40, p=16, limit=5)),
    "max_parallel": (3100, dict(n=30, p=20, a=8, limit=4, maxp=1,
                                n_groups=3)),
    "distinct_hosts": (3200, dict(n=50, p=20, limit=5, distinct=True)),
    "affinity_penalty": (3300, dict(n=40, p=16, limit=5, affinity=True,
                                    pen_frac=0.3)),
    "saturation": (3400, dict(n=10, p=24, limit=3, fill=0.85)),
}


@pytest.mark.parametrize("dtype_name", DTYPES)
@pytest.mark.parametrize("world", list(WORLDS))
def test_dense_and_wave_match_reference(world, dtype_name):
    """Both plain versions against the JAX programs on the windowed
    kernel's test worlds; on every world but max_parallel (which the wave
    gate keeps dense) the port's wave and dense results agree too."""
    seed, kw = WORLDS[world]
    rlane, plane = _lane(_world(random.Random(seed), **kw), dtype_name)
    dense = _check_dense(rlane, plane, dtype_name)
    wave = _check_wave(rlane, plane, dtype_name)
    assert bool((dense.chosen >= 0).any())
    if world != "max_parallel":
        np.testing.assert_array_equal(wave[0][0], dense.chosen[0].numpy())
        np.testing.assert_array_equal(wave[3][0],
                                      dense.evict_rows[0].numpy())
        assert wave[3].any()


@pytest.mark.parametrize("dtype_name", DTYPES)
@pytest.mark.parametrize("features", FEATURE_SETS, ids="-".join)
def test_fuzz_lanes_match_reference(features, dtype_name):
    """chip_smoke's fuzz lanes, each through both plain versions against
    the JAX programs (the windowed one runs on max_parallel lanes too:
    only the gate keeps those dense)."""
    rlane, plane = _fuzz(23, features, dtype_name, p=14,
                         limit=3 if "scarce" in features else 5)
    out = _check_dense(rlane, plane, dtype_name)
    _check_wave(rlane, plane, dtype_name)
    if "inert" in features:
        assert bool((out.chosen == -1).all())


@pytest.mark.parametrize("dtype_name", DTYPES)
def test_wide_window_lane_matches_reference(dtype_name):
    """An affinity lane's limit-100 window takes the windowed kernel's
    wide buffer (B = 128) in both packages."""
    rlane, plane = _fuzz(31, ("affinity", "tiers"), dtype_name, n=160,
                         n_pad=256, p=10, limit=100)
    inp = preempt.wave_preempt_inputs(*_stack([plane]),
                                      dtype_name=dtype_name)
    assert inp.B == 128
    _check_wave(rlane, plane, dtype_name)
    _check_dense(rlane, plane, dtype_name)


@pytest.mark.parametrize("dtype_name", DTYPES)
def test_widest_candidate_axis_matches_reference(dtype_name):
    """A = 64, the widest candidate axis the kernels take, with every
    column in use (nodes of up to ~80 small allocs)."""
    rlane, plane = _fuzz(37, ("many", "tiers", "penalties"), dtype_name,
                         n=24, n_pad=32, p=10, A=64)
    assert bool(plane[3].valid[:, 40:].any())
    _check_wave(rlane, plane, dtype_name)
    _check_dense(rlane, plane, dtype_name)


@pytest.mark.parametrize("dtype_name", DTYPES)
def test_batched_lanes_with_inert_padding(dtype_name):
    """A fused group: three real lanes and five inert padding replicas
    (active all False) solve as one batch, each real lane equal to the
    reference's vmapped programs, the padding placing nothing."""
    real = [_lane(_world(random.Random(3500 + k), n=24, p=12, limit=4),
                  dtype_name) for k in range(3)]
    pad_r, pad_p = real[0]
    pad = (pad_r[:2] + (pad_r[2]._replace(
        active=np.zeros_like(pad_r[2].active)),) + pad_r[3:],
           pad_p[:2] + (pad_p[2]._replace(
               active=np.zeros_like(pad_p[2].active)),) + pad_p[3:])
    lanes = real + [pad] * 5
    rstack = _stack([r for r, _ in lanes])
    pstack = _stack([p for _, p in lanes])
    want_d = ref.solve_eval_batch_preempt(*rstack, spread_alg=False,
                                          dtype_name=dtype_name)
    got_d = preempt.solve_placements_preempt(
        *pstack, spread_alg=False, dtype_name=dtype_name, device="cpu")
    _assert_out_equal(want_d, got_d, dtype_name)
    want_w = ref.solve_lane_wave_preempt(*rstack, spread_alg=False,
                                         dtype_name=dtype_name,
                                         batched=True)
    got_w = preempt.solve_lane_wave_preempt(
        *pstack, spread_alg=False, dtype_name=dtype_name, device="cpu")
    _assert_out_equal(want_w, got_w, dtype_name, state=False)
    assert (got_w[0][3:] == -1).all() and (got_d.chosen[3:] == -1).all()
    assert (got_w[0][:3] >= 0).any()


def test_inactive_step_after_a_preempting_winner_frees_like_reference():
    """An inactive step whose window winner would preempt still takes the
    freed resources off that node's usage in the reference (they are not
    masked by ``active``): the port's plain version does the same, so
    outputs past the last placement and the final state agree."""
    rlane, plane = _lane(_world(random.Random(3001), n=40, p=16, limit=5),
                         "float64")
    act = np.arange(16) < 6
    rlane = rlane[:2] + (rlane[2]._replace(active=act),) + rlane[3:]
    plane = plane[:2] + (plane[2]._replace(active=act),) + plane[3:]
    out = _check_dense(rlane, plane, "float64")
    chosen = out.chosen[0].numpy()
    rows = out.evict_rows[0].numpy()
    assert int((chosen >= 0).sum()) == 6
    evicted_cpu = sum(float(plane[3].cpu[chosen[k]][rows[k]].sum())
                      for k in range(16) if chosen[k] >= 0)
    accounted = plane[1].used_cpu.sum() + 6 * 1000.0 - evicted_cpu
    assert float(out.state.used_cpu.sum()) < accounted


# --------------------------------------------------------------------------
# wrappers

def _fused(trees, dtype_name):
    """Stacked numpy (const, init, batch, ptab, pinit) as tensors on the
    CPU, shipped through the fused transport as solve_placements_preempt
    ships them."""
    ten, _ = preempt.dense.fused_tensors(
        trees, preempt.preempt_casts(dtype_name), device=torch.device("cpu"))
    return ten


def test_wrappers_check_their_inputs():
    (_, _, _, _, _), plane = _fuzz(3, ("tiers",), "float64")
    dtype_name = "float64"
    c, s, b, pt, ps = _fused(_stack([plane]), dtype_name)
    good = preempt.dense_preempt(c, s, b, pt, ps, spread_alg=False)
    assert good.evict_rows.shape == (1, 12, 8)
    with pytest.raises(TypeError, match="dtype"):
        preempt.dense_preempt(c, s, b, pt._replace(prio=pt.prio.long()), ps,
                              spread_alg=False)
    with pytest.raises(ValueError, match="index"):
        preempt.dense_preempt(c, s, b, pt._replace(grp=pt.grp + 8), ps,
                              spread_alg=False)
    wide = pt._replace(**{f: torch.cat([getattr(pt, f)] * 9, dim=2)
                          for f in ("cpu", "mem", "disk", "prio", "maxp",
                                    "grp", "dyn_ports", "static_rel",
                                    "valid")})
    with pytest.raises(ValueError, match="A=72"):
        preempt.dense_preempt(c, s, b, wide, ps._replace(
            evicted=torch.cat([ps.evicted] * 9, dim=2)), spread_alg=False)
    inp = preempt.wave_preempt_inputs(*_stack([plane]),
                                      dtype_name=dtype_name)
    cm, cand, sf, si, pn, c0 = preempt.wave_preempt_tensors(
        inp, torch.device("cpu"))
    got = preempt.wave_preempt(cm, cand, sf, si, pn, c0, spread_alg=False,
                               B=inp.B)
    assert got[3].shape == (1, inp.compact.shape[1] - inp.B, 8)
    with pytest.raises(ValueError, match="B=64"):
        preempt.wave_preempt(cm, cand, sf, si, pn, c0, spread_alg=False,
                             B=64)
    with pytest.raises(TypeError, match="dtype"):
        preempt.wave_preempt(cm, cand, sf.float(), si, pn, c0,
                             spread_alg=False, B=inp.B)
    meta = [t.to("meta") for t in (cm, sf, si, pn, c0)]
    with pytest.raises(ValueError, match="unsupported device"):
        preempt.wave_preempt(meta[0], {k: v.to("meta")
                                       for k, v in cand.items()},
                             *meta[1:], spread_alg=False, B=inp.B)


def test_preemption_kernels_are_registered():
    names = {k.name: k for k in kernels.KERNELS}
    assert names["wave_preempt"].replaces == (
        "nomad_tpu/solver/binpack.py:2293 _solve_wave_preempt_impl")
    assert names["dense_preempt"].replaces == (
        "nomad_tpu/solver/binpack.py:732 _solve_placements_preempt_impl")
    for k in (names["wave_preempt"], names["dense_preempt"]):
        src = (kernels.CSRC / k.source).read_text()
        assert "preempt_common.cuh" in src and k.replaces.split()[-1] in src
    common = (kernels.CSRC / "preempt_common.cuh").read_text()
    assert f"kMaxA = {preempt.MAX_A}" in common


# --------------------------------------------------------------------------
# chip_smoke's bounds of the two kernels

def _pad_nodes(tree, n, n_to):
    """``tree`` with every axis of size ``n`` zero-padded to ``n_to``
    (the added nodes infeasible, with no capacity or candidates)."""
    def pad(a):
        a = np.asarray(a)
        widths = [(0, n_to - n if d == n else 0) for d in a.shape]
        return np.pad(a, widths) if a.ndim else a
    return type(tree)(*(pad(a) for a in tree))


def test_dense_preempt_bound_counts_rows_the_window_reaches():
    """The dense bound counts the node rows each lane's window walk must
    reach, not whole tables: padding the node axis far past the window
    changes no decision and leaves the bound's bytes as they were, while
    the whole tables grow eightfold."""
    _, plane = _fuzz(7, ("tiers", "maxp"), "float32", limit=3)
    outs, bounds, whole = [], [], []
    for n_to in (64, 512):
        trees = _stack([tuple(_pad_nodes(t, 64, n_to) for t in plane)] * 2)
        ten = _fused(trees, "float32")
        out = preempt.dense_preempt_plain(*ten, spread_alg=False)
        outs.append(out)
        bounds.append(chip_smoke.dense_preempt_bound(np, ten, out,
                                                     "float32"))
        whole.append(chip_smoke.tree_nbytes(ten))
    assert bool(outs[0].evict_rows.any())
    assert not bool((outs[0].n_yielded < 3).any())
    for a, b in zip(outs[0][:4], outs[1][:4]):
        assert torch.equal(a, b)
    assert bounds[0][2:] == bounds[1][2:]
    assert whole[1] > 7 * whole[0] > 7 * bounds[0][2]


def test_wave_preempt_bound_counts_rows_up_to_the_last_choice():
    """The windowed bound counts the compact and candidate rows up to the
    row of the last node chosen (at least the B first), the scalars,
    penalties, max_parallel group counts and outputs, and no more."""
    _, plane = _fuzz(11, ("distinct",), "float32", n=96, n_pad=128, p=40,
                     limit=3)
    inp = preempt.wave_preempt_inputs(*_stack([plane]),
                                      dtype_name="float32")
    out = preempt.wave_preempt_plain(
        *preempt.wave_preempt_tensors(inp, torch.device("cpu")),
        spread_alg=False, B=inp.B)
    chosen = out[0][0].numpy()
    pos = inp.compact[0, :, port_bp.WPC_POS]
    last = max(int(np.nonzero(pos == c)[0][0]) for c in chosen if c >= 0)
    assert last >= inp.B        # one node a placement: past the B first
    rows = last + 1
    assert rows < inp.compact.shape[1]
    assert not (inp.cand["maxp"] > 0).any()
    want = (inp.compact[:, :rows].nbytes
            + sum(v[:, :rows].nbytes for v in inp.cand.values())
            + inp.scal_f.nbytes + inp.scal_i.nbytes + inp.pen.nbytes
            + sum(t.nbytes for t in out))
    assert chip_smoke.wave_preempt_bound(np, preempt, inp, out,
                                         "float32")[2] == want
