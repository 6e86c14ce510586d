"""The port's plain wave kernels against the JAX programs they replace.

nomad_tpu_torch.solver.wave.wave_compact_plain and wave_block_plain must
reproduce nomad_tpu/solver/binpack.py's _solve_wave_compact_impl and
_solve_wave_block_impl (vmapped over lanes, run on the CPU as the
reference's own tests run them) on the same inputs:

  * chosen and n_yielded exactly;
  * scores within rtol=1e-12 in float64 (the reference's own gate,
    tests/test_wavefront.py) and rtol=1e-6 in float32 -- about eight
    float32 ulps. The port evaluates the same IEEE operations in the same
    order, including XLA's rewrites (division by 18 as a multiply by the
    rounded reciprocal fused into the following add; libm pow), so the
    scores are in fact expected to agree to the bit; the float32 margin
    only names how far a reordering could move them.

Inputs come from the reference tests' own generators: the
tests/test_wave_block.py fuzz (capacities down to 1 force saturation and
refill chains, huge prior collision counts drive scores through the skip
threshold both ways) and the tests/test_wavefront.py worlds (ports,
distinct_hosts, affinities, spreads in even and target form), plus
reschedule penalties.
"""
import functools
from functools import partial

import jax
import numpy as np
import pytest
import torch

from nomad_tpu.solver import binpack as ref
from test_wave_block import _make_case

from nomad_tpu_torch.solver import binpack as port_bp
from nomad_tpu_torch.solver import wave

# One intra-op thread: the port's CPU tensors are small, and the test
# run already keeps one xdist worker busy per core.
torch.set_num_threads(1)

RTOL = {np.float64: 1e-12, np.float32: 1e-6}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _port_sp(sp):
    return port_bp.WaveSpread(*(_t(np.asarray(a)) for a in sp))


def _assert_same(want, got, dtype):
    ch_w, sc_w, ny_w = (np.asarray(x) for x in want)
    ch, sc, ny = (x.numpy() if isinstance(x, torch.Tensor) else x
                  for x in got)
    np.testing.assert_array_equal(ch, ch_w)
    np.testing.assert_array_equal(ny, ny_w)
    np.testing.assert_allclose(sc, sc_w, rtol=RTOL[dtype])


@functools.lru_cache(maxsize=None)
def _compact_program(spread_alg, dtype_name, B):
    # one jitted program per static signature; jit itself caches the
    # compiled executable per input shape, so same-shaped cases share it
    return jax.jit(jax.vmap(partial(
        ref._solve_wave_compact_impl, spread_alg=spread_alg,
        dtype_name=dtype_name, B=B)))


def _ref_compact(cm, sf, si, pen, sp, *, spread_alg, dtype_name, B):
    return _compact_program(spread_alg, dtype_name, B)(cm, sf, si, pen, sp)


def _fuzz_lanes(C, B, L, dtype, n_lanes=8):
    """E lanes of the reference's block-vs-classic fuzz (same seeds)."""
    P = C - B
    cms, sfs, sis = [], [], []
    for seed in range(n_lanes):
        rng = np.random.default_rng(seed * 7919 + C)
        cm, sf = _make_case(rng, C, B)
        n_active = int(rng.integers(1, P + 1))
        cms.append(cm.astype(dtype))
        sfs.append(sf.astype(dtype))
        sis.append(np.array([L, n_active], dtype=np.int32))
    pen = np.full((n_lanes, P), -1, dtype=np.int32)
    return np.stack(cms), np.stack(sfs), np.stack(sis), pen


def _empty_sp(E, dtype):
    return ref._WaveSpread(
        counts=np.zeros((E, 0, 1), dtype=np.int32),
        desired=np.zeros((E, 0, 1), dtype=dtype),
        has_targets=np.zeros((E, 0), dtype=bool),
        weights=np.zeros((E, 0), dtype=dtype),
        sum_weights=np.zeros(E, dtype=dtype))


FUZZ_SHAPES = [(40, 8, 5), (160, 32, 14), (96, 32, 3), (360, 128, 100)]


@pytest.mark.parametrize("spread_alg,dtype", [
    (False, np.float32), (False, np.float64), (True, np.float32)])
@pytest.mark.parametrize("C,B,L", FUZZ_SHAPES)
def test_fuzz_plain_kernels_match_jax(C, B, L, spread_alg, dtype):
    """Both plain kernels equal the JAX compact program on 8 fuzz lanes
    at once (E > 1); the block kernel is the same for every run width K.
    (The reference's own fuzz holds its block program to its compact
    one; the worlds tests hold the port to the JAX block program.)"""
    dn = np.dtype(dtype).name
    cm, sf, si, pen = _fuzz_lanes(C, B, L, dtype)
    sp = _empty_sp(cm.shape[0], dtype)
    want = _ref_compact(cm, sf, si, pen, sp, spread_alg=spread_alg,
                        dtype_name=dn, B=B)
    got = wave.wave_compact(_t(cm), _t(sf), _t(si), _t(pen), _port_sp(sp),
                            spread_alg=spread_alg, B=B)
    _assert_same(want, got, dtype)
    for K in (5, 32):
        got_b = wave.wave_block_plain(_t(cm), _t(sf), _t(si),
                                      spread_alg=spread_alg, B=B, K=K)
        _assert_same(want, got_b, dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("C,B,L", [(96, 32, 3), (360, 128, 100)])
def test_fuzz_penalties_compact_matches_jax(C, B, L, dtype):
    """Reschedule penalties on random steps -- also past n_active and
    after a lane stops placing, where the penalty still moves the emitted
    best-head score -- through the compact kernel."""
    dn = np.dtype(dtype).name
    cm, sf, si, pen = _fuzz_lanes(C, B, L, dtype, n_lanes=8)
    rng = np.random.default_rng(C + B)
    hot = rng.random(pen.shape) < 0.3
    pen[hot] = rng.integers(0, C, size=int(hot.sum()))
    sp = _empty_sp(cm.shape[0], dtype)
    want = _ref_compact(cm, sf, si, pen, sp, spread_alg=False,
                        dtype_name=dn, B=B)
    got = wave.wave_compact(_t(cm), _t(sf), _t(si), _t(pen), _port_sp(sp),
                            spread_alg=False, B=B)
    _assert_same(want, got, dtype)


def test_wrappers_reject_bad_inputs():
    cm, sf, si, pen = _fuzz_lanes(40, 8, 5, np.float32, n_lanes=2)
    with pytest.raises(TypeError):
        wave.wave_block(_t(cm), _t(sf.astype(np.float64)), _t(si),
                        spread_alg=False, B=8)
    with pytest.raises(ValueError):
        wave.wave_block(_t(cm), _t(sf), _t(si[:1]), spread_alg=False, B=8)
    with pytest.raises(ValueError):
        wave.wave_block(_t(cm).transpose(1, 2).contiguous().transpose(1, 2),
                        _t(sf), _t(si), spread_alg=False, B=8)
    with pytest.raises(ValueError):
        wave.wave_compact(_t(cm), _t(sf), _t(si), _t(pen[:, :3]),
                          _port_sp(_empty_sp(2, np.float32)),
                          spread_alg=False, B=8)
    meta = torch.empty(cm.shape, dtype=torch.float32, device="meta")
    with pytest.raises(ValueError):
        wave.wave_block(meta, _t(sf).to("meta"), _t(si).to("meta"),
                        spread_alg=False, B=8)
