"""The port's plain wave kernels against the JAX programs on the
tests/test_wavefront.py worlds (ports, distinct_hosts, affinities,
exhaustion, low-score skips, spreads in even and target form) plus
reschedule penalties, several lanes stacked per dispatch. Decisions must
match exactly; tolerances and their reasons are those of
tests/test_torch_wave.py."""
import functools
import random
from functools import partial

import jax
import numpy as np
import pytest
import torch

from nomad_tpu.solver import binpack as ref
from test_torch_wave import _assert_same, _port_sp, _ref_compact, _t
from test_wavefront import _world

from nomad_tpu_torch.solver import wave

# One intra-op thread: the port's CPU tensors are small, and the test
# run already keeps one xdist worker busy per core.
torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _block_program(spread_alg, dtype_name, B):
    # the reference's CPU run-block shape (K, INNER) = (16, 32)
    return jax.jit(jax.vmap(partial(
        ref._solve_wave_block_impl, spread_alg=spread_alg,
        dtype_name=dtype_name, B=B, K=16, INNER=32)))


def _ref_block(cm, sf, si, pen, *, spread_alg, dtype_name, B):
    return _block_program(spread_alg, dtype_name, B)(cm, sf, si, pen)


def _world_lanes(seeds, dtype, *, n, p, limit, penalties=False, **kw):
    """Stack several test_wavefront worlds' compact tables (reference
    host precompute) into one E-lane dispatch."""
    dn = np.dtype(dtype).name
    B = ref.wavefront_buffer_size(limit)
    # one placement bucket for every world (p <= 45), so worlds share
    # compiled JAX programs; tests/test_torch_wave.py covers other buckets
    p_pad = 64
    assert p <= p_pad
    packs = []
    for seed in seeds:
        rng = random.Random(seed)
        const, init, batch = _world(rng, n=n, p=p, limit=limit, **kw)
        if penalties:
            pen = np.full(p, -1, dtype=np.int32)
            for i in range(0, p, 3):
                pen[i] = rng.randrange(n)
            batch = batch._replace(penalty_idx=pen)
        packs.append(ref.wavefront_compact_host(
            const, init, batch, dn, p_pad=p_pad, B=B))
    cm, sf, si, pen = (np.stack([pk[k] for pk in packs]) for k in range(4))
    sp = ref._WaveSpread(*(np.stack(xs) for xs in zip(
        *[pk[4] for pk in packs])))
    return cm, sf, si, pen, sp, B


WORLDS = {
    "plain": dict(n=40, p=30, limit=6),
    "exhaustion": dict(n=6, p=40, ask=(1500, 2048, 300), limit=3),
    "distinct": dict(n=50, p=35, distinct=True, job_level=True, limit=6),
    "ports": dict(n=40, p=30, n_dyn=7, has_static=True, limit=5),
    "affinity": dict(n=40, p=30, limit=6, affinity=True),
    "low_score": dict(n=30, p=40, low_score=True, count=1, limit=4),
    "wide_affinity": dict(n=60, p=40, limit=100, affinity=True),
}


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("world,spread_alg", [
    (w, False) for w in sorted(WORLDS)] + [("plain", True),
                                           ("low_score", True)])
def test_worlds_without_spreads(world, spread_alg, dtype):
    """Lanes the block kernel takes: both plain kernels equal the JAX
    block and compact programs on four stacked worlds."""
    dn = np.dtype(dtype).name
    cm, sf, si, pen, sp, B = _world_lanes(
        [100 * sorted(WORLDS).index(world) + k for k in range(4)], dtype,
        **WORLDS[world])
    want = _ref_block(cm, sf, si, pen, spread_alg=spread_alg, dtype_name=dn,
                      B=B)
    got = wave.wave_block(_t(cm), _t(sf), _t(si), spread_alg=spread_alg,
                          B=B)
    _assert_same(want, got, dtype)
    got_c = wave.wave_compact(_t(cm), _t(sf), _t(si), _t(pen), _port_sp(sp),
                              spread_alg=spread_alg, B=B)
    _assert_same(want, got_c, dtype)
    assert (got[0].numpy() >= 0).any()


SPREAD_WORLDS = {
    "even": dict(n=60, p=40, limit=100, spreads=2, spread_values=4),
    "target": dict(n=60, p=40, limit=100, spreads=2, spread_values=5,
                   spread_targets=True),
    "affinity_ports": dict(n=50, p=30, limit=100, spreads=1,
                           spread_values=4, affinity=True, n_dyn=5),
    "three": dict(n=50, p=45, limit=100, spreads=3, spread_values=3,
                  low_score=True, count=2),
}


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("world", sorted(SPREAD_WORLDS))
def test_spread_worlds(world, dtype):
    """Spread lanes (the compact kernel's carry of (S, V) counts), with
    reschedule penalties on every third placement of two lanes."""
    dn = np.dtype(dtype).name
    kw = SPREAD_WORLDS[world]
    cm, sf, si, pen, sp, B = _world_lanes(
        [1000 + 7 * k for k in range(3)], dtype, **kw)
    cm2, sf2, si2, pen2, sp2, _ = _world_lanes(
        [1100 + 7 * k for k in range(2)], dtype, penalties=True, **kw)
    cm, sf, si, pen = (np.concatenate(x) for x in
                       ((cm, cm2), (sf, sf2), (si, si2), (pen, pen2)))
    sp = ref._WaveSpread(*(np.concatenate(x) for x in zip(sp, sp2)))
    assert B == 128 and (pen >= 0).any()
    want = _ref_compact(cm, sf, si, pen, sp, spread_alg=False,
                        dtype_name=dn, B=B)
    got = wave.wave_compact(_t(cm), _t(sf), _t(si), _t(pen), _port_sp(sp),
                            spread_alg=False, B=B)
    _assert_same(want, got, dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_penalty_lanes_log2_window(dtype):
    """Reschedule penalties on a B=32 lane (the compact kernel without
    spreads): decisions and scores equal the JAX compact program."""
    dn = np.dtype(dtype).name
    cm, sf, si, pen, sp, B = _world_lanes(
        [1200 + k for k in range(4)], dtype, penalties=True, n=40, p=30,
        limit=6, low_score=True)
    assert B == 32
    want = _ref_compact(cm, sf, si, pen, sp, spread_alg=False,
                        dtype_name=dn, B=B)
    got = wave.wave_compact(_t(cm), _t(sf), _t(si), _t(pen), _port_sp(sp),
                            spread_alg=False, B=B)
    _assert_same(want, got, dtype)
