"""The port's host-side packing equals the reference's bit for bit: the
node shuffle (it decides tie-breaks), the shuffled NodeConst / NodeState
tables, and the wavefront compact-table precompute, on the
tests/test_wavefront.py worlds."""
import random

import numpy as np
import pytest
import torch

from nomad_tpu.scheduler import util as ref_util
from nomad_tpu.solver import binpack as ref_bp
from nomad_tpu.tensor import pack as ref_pack
from test_wavefront import _world

from nomad_tpu_torch.scheduler import util as port_util
from nomad_tpu_torch.solver import binpack as port_bp
from nomad_tpu_torch.tensor import pack as port_pack

# One intra-op thread: the port's CPU tensors are small, and the test
# run already keeps one xdist worker busy per core.
torch.set_num_threads(1)


def _assert_tree_equal(a, b):
    assert type(a).__name__ == type(b).__name__
    for name in type(b)._fields:
        x, y = np.asarray(getattr(a, name)), np.asarray(getattr(b, name))
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.mark.parametrize("eval_id,index,n", [
    ("9f0c1f4e-1c1e-4b9c-9a3e-6d7f1c2b3a4d", 17, 300),
    ("fused-bench-eval-0000000000000007", 10001, 1000),
    ("e", 0, 2), ("", 5, 1), ("abc", 2 ** 63 + 12345, 64)])
def test_shuffled_order_matches_reference(eval_id, index, n):
    assert (port_util.shuffle_seed(eval_id, index)
            == ref_util.shuffle_seed(eval_id, index))
    assert (port_util.shuffled_order(eval_id, index, n)
            == ref_util.shuffled_order(eval_id, index, n))
    state = port_util.shuffle_seed(eval_id, index)
    for _ in range(3):
        assert port_util.splitmix64(state) == ref_util.splitmix64(state)
        state = port_util.splitmix64(state)[0]


def test_buckets_and_buffer_sizes_match_reference():
    for n in (1, 63, 64, 65, 300, 10000, 16384, 70000):
        assert port_pack.bucket_size(n) == ref_pack.bucket_size(n)
    for lim in range(0, 140):
        assert (port_bp.wavefront_buffer_size(lim)
                == ref_bp.wavefront_buffer_size(lim))
    for p in (1, 31, 32, 33, 2000, 2048, 2049):
        assert port_bp._wave_p_bucket(p) == ref_bp._wave_p_bucket(p)
    for name in ("MAX_SKIP", "SKIP_THRESHOLD", "BINPACK_MAX", "WAVE_B",
                 "WAVE_B_WIDE", "WAVE_P_BUCKETS_MIN", "WAVE_K"):
        assert getattr(port_bp, name) == getattr(ref_bp, name), name


def _arrays_from_world(seed, **kw):
    """A _world's tables read as original-order node arrays: the port's
    NodeMatrix / UsageState / SpreadInfo (the reference functions accept
    them too -- they read the same attributes)."""
    rng = random.Random(seed)
    const, init, batch = _world(rng, **kw)
    n = const.cpu_cap.shape[0]
    n_pad = port_pack.bucket_size(n)

    def pad(a, fill=0):
        out = np.full(n_pad, fill, dtype=np.asarray(a).dtype)
        out[:n] = a
        return out

    matrix = port_pack.NodeMatrix(
        n_real=n, n_pad=n_pad, node_ids=[f"node-{i}" for i in range(n)],
        cpu_cap=pad(const.cpu_cap), mem_cap=pad(const.mem_cap),
        disk_cap=pad(const.disk_cap),
        dyn_free=pad(np.asarray(init.dyn_avail) + 3),
        valid=pad(np.ones(n, dtype=bool), False))
    usage = port_pack.UsageState(
        used_cpu=pad(init.used_cpu), used_mem=pad(init.used_mem),
        used_disk=pad(init.used_disk), placed_jobtg=pad(init.placed),
        placed_job=pad(init.placed_job),
        dyn_used=pad(np.full(n, 3, dtype=np.int32)))
    spread = None
    S = const.spread_vidx.shape[0]
    if S:
        vidx = np.full((S, n_pad), -1, dtype=np.int32)
        vidx[:, :n] = const.spread_vidx
        spread = port_pack.SpreadInfo(
            n_spreads=S, value_index=vidx,
            n_values=const.spread_desired.shape[1],
            desired=np.asarray(const.spread_desired, dtype=np.float64),
            has_targets=np.asarray(const.spread_has_targets),
            weights=np.asarray(const.spread_weights, dtype=np.float64),
            sum_weights=float(const.spread_sum_weights),
            initial_counts=np.asarray(init.spread_counts))
    affinity = pad(const.affinity) if bool(const.has_affinity) else None
    return (matrix, usage, spread, affinity, pad(const.feasible, False),
            pad(init.static_free, True), const, batch)


WORLDS = [
    dict(n=40, p=30, limit=6),
    dict(n=50, p=35, distinct=True, job_level=True, limit=6),
    dict(n=40, p=30, n_dyn=7, has_static=True, limit=5),
    dict(n=60, p=40, limit=100, spreads=2, spread_values=5,
         spread_targets=True, affinity=True),
    dict(n=30, p=40, low_score=True, count=1, limit=4),
]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("world", range(len(WORLDS)))
def test_node_tables_match_reference(world, dtype):
    (matrix, usage, spread, affinity, feasible, static_free, const,
     _) = _arrays_from_world(50 + world, **WORLDS[world])
    order = port_util.shuffled_order("eval-" + str(world), 7, matrix.n_real)
    perm = np.concatenate([np.asarray(order, dtype=np.int64),
                           np.arange(matrix.n_real, matrix.n_pad)])
    distinct = bool(const.distinct_hosts)
    job_level = bool(const.distinct_job_level)
    _assert_tree_equal(
        port_bp.make_node_const(matrix, feasible, affinity, distinct, spread,
                                perm, dtype=dtype,
                                distinct_job_level=job_level),
        ref_bp.make_node_const(matrix, feasible, affinity, distinct, spread,
                               perm, dtype=dtype,
                               distinct_job_level=job_level))
    S = spread.n_spreads if spread else 0
    V = spread.n_values if spread else 1
    counts = spread.initial_counts if spread else None
    _assert_tree_equal(
        port_bp.make_node_state(usage, matrix, static_free, perm, S, V,
                                spread_counts=counts, dtype=dtype),
        ref_bp.make_node_state(usage, matrix, static_free, perm, S, V,
                               spread_counts=counts, dtype=dtype))


@pytest.mark.parametrize("dtype_name", ["float32", "float64"])
@pytest.mark.parametrize("world", range(len(WORLDS)))
def test_wavefront_compact_host_matches_reference(world, dtype_name):
    rng = random.Random(90 + world)
    const, init, batch = _world(rng, **WORLDS[world])
    pen = np.asarray(batch.penalty_idx).copy()
    pen[::4] = 3
    batch = batch._replace(penalty_idx=pen)
    B = ref_bp.wavefront_buffer_size(int(batch.limit[0]))
    p = batch.ask_cpu.shape[0]
    for p_pad in (None, ref_bp._wave_p_bucket(p), 2 * ref_bp._wave_p_bucket(p)):
        want = ref_bp.wavefront_compact_host(const, init, batch, dtype_name,
                                             p_pad=p_pad, B=B)
        got = port_bp.wavefront_compact_host(const, init, batch, dtype_name,
                                             p_pad=p_pad, B=B)
        for w, g in zip(want[:4], got[:4]):
            assert w.dtype == g.dtype
            np.testing.assert_array_equal(g, w)
        _assert_tree_equal(got[4], port_bp.WaveSpread(*want[4]))
