"""Device residency in the port (nomad_tpu_torch/solver/resident.py and
state/store.py) against the reference (nomad_tpu/solver/constcache.py and
state/store.py) on the CPU:

  * the alloc-delta journal answers alloc_deltas_since exactly as the
    reference store does, over one write sequence with a delta-less write
    and an overflow past a capacity of 8;
  * delta_scatter_plain (the plain version of csrc/delta_scatter.cu)
    equals the reference's _delta_scatter_program as bytes, per dtype,
    with -0.0, NaN payloads, inf and duplicated padding indices;
  * the reference's own residency scenarios (tests/test_constcache.py,
    tests/test_delta_stream.py), ported to the port's resident set and
    store;
  * one generation sequence through both packages' solve_lane_fused
    (wave, dense, windowed- and dense-preemption groups carried over by
    lane_from_reference, fed by one reference StateStore with real
    upsert_allocs): equal decisions, equal resident-set counters and
    bytes, and every chain buffer equal to its frozen shadow.
"""
import random

import numpy as np
import pytest
import torch

from nomad_tpu import mock
from nomad_tpu.solver import constcache

from nomad_tpu_torch.solver import resident
from nomad_tpu_torch.state.store import StateStore
from nomad_tpu_torch.tensor.pack import journal_touched_nodes

torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv("NOMAD_TPU_MESH", "0")
    resident._reset_for_tests()
    constcache._reset_for_tests()
    yield
    resident._reset_for_tests()
    constcache._reset_for_tests()


def host(t):
    return t.cpu().numpy()


def same_bytes(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and (a.reshape(-1).view(np.uint8)
                 == b.reshape(-1).view(np.uint8)).all())


# ----------------------------------------------------------------------
# the journal


class _Alloc:
    def __init__(self, aid, node_id):
        self.id = aid
        self.node_id = node_id


def test_journal_matches_reference_store(monkeypatch):
    """One sequence of alloc writes (inserts, a replacement, a delete, a
    delta-less write, then enough writes to wrap a journal of 8) through
    both stores: alloc_deltas_since agrees for every (index, upto), pair
    by pair, and the overflow is counted."""
    from nomad_tpu.state.store import StateStore as RefStore

    monkeypatch.setenv("NOMAD_TPU_DELTA_JOURNAL", "8")
    monkeypatch.setenv("NOMAD_TPU_TORCH_DELTA_JOURNAL", "8")
    ref, port = RefStore(), StateStore()
    assert port.latest_index() == ref.latest_index() == 1
    job = mock.job(id="journal-job")
    nodes = [mock.node() for _ in range(3)]
    allocs = [mock.alloc_for(job, nodes[k % 3], index=k) for k in range(14)]

    def both(fn_ref, fn_port):
        i, j = fn_ref(), fn_port()
        assert i == j
        return i

    snapshots = []

    def answers():
        top = ref.latest_index()
        out = {}
        for i in range(top + 1):
            for upto in [None] + list(range(i, top + 1)):
                out[(i, upto)] = ref.alloc_deltas_since(i, upto=upto)
        return out

    def check():
        want = answers()
        for (i, upto), (cov, pairs) in want.items():
            gcov, gpairs = port.alloc_deltas_since(i, upto=upto)
            assert gcov == cov, (i, upto)
            assert len(gpairs) == len(pairs), (i, upto)
            for (a, b), (c, d) in zip(gpairs, pairs):
                assert a is c and b is d, (i, upto)
        snapshots.append(len(want))

    both(lambda: ref.upsert_allocs(allocs[:2]),
         lambda: port.upsert_allocs(allocs[:2]))
    both(lambda: ref.upsert_allocs(allocs[2:3]),
         lambda: port.upsert_allocs(allocs[2:3]))
    check()
    # a replacement: (old, new) with the old object
    both(lambda: ref.upsert_allocs([allocs[0]]),
         lambda: port.upsert_allocs([allocs[0]]))
    both(lambda: ref.delete_allocs([allocs[1].id]),
         lambda: port.delete_allocs([allocs[1].id]))
    check()
    # a write with no structured delta: an explicit gap
    with ref._lock:
        i = ref._bump("allocs")
    assert port.replace_allocs(port.allocs()) == i
    both(lambda: ref.upsert_allocs(allocs[3:4]),
         lambda: port.upsert_allocs(allocs[3:4]))
    check()
    # wrap the journal of 8
    for k in range(4, 14):
        both(lambda k=k: ref.upsert_allocs([allocs[k]]),
             lambda k=k: port.upsert_allocs([allocs[k]]))
    check()
    assert port.delta_journal_overflow > 0
    assert port.alloc_deltas_since(0) == (False, [])
    assert port.latest_index() == ref.latest_index()
    assert port.table_index("allocs") == ref.table_index("allocs")


def test_journal_cap_knob_has_a_floor(monkeypatch):
    monkeypatch.setenv("NOMAD_TPU_TORCH_DELTA_JOURNAL", "2")
    assert StateStore()._alloc_deltas.maxlen == 8
    monkeypatch.setenv("NOMAD_TPU_TORCH_DELTA_JOURNAL", "junk")
    assert StateStore()._alloc_deltas.maxlen == 128


def test_journal_touched_nodes_matches_reference():
    from nomad_tpu.tensor.pack import journal_touched_nodes as ref_touched
    job = mock.job(id="touch-job")
    nodes = [mock.node() for _ in range(4)]
    a = [mock.alloc_for(job, n) for n in nodes]
    pairs = [(None, a[0]), (a[1], a[2]), (a[3], None), (None, None)]
    assert journal_touched_nodes(pairs) == ref_touched(pairs)
    assert journal_touched_nodes(pairs) == {n.id for n in nodes}


# ----------------------------------------------------------------------
# the delta scatter

SCATTER_DTYPES = ["float32", "float64", "int32", "int64", "bool", "uint8",
                  "int16", "float16"]


def _scatter_case(dtype, m, n_upd, seed):
    rng = np.random.default_rng(seed)
    dt = np.dtype(dtype)
    if dt.kind == "f":
        buf = rng.standard_normal(m).astype(dt)
        specials = np.array([-0.0, 0.0, np.inf, -np.inf, np.nan],
                            dtype=dt)
        buf[:specials.size] = specials
        vals = rng.standard_normal(n_upd).astype(dt)
        k = min(n_upd, specials.size)
        vals[:k] = specials[::-1][:k]
        # NaNs with distinct payloads: the bits must survive
        bits = vals.view(np.dtype("u%d" % dt.itemsize))
        nan = np.array([np.nan], dtype=dt).view(bits.dtype)[0]
        bits[-2:] = [nan | 1, nan | 3]
    elif dt.kind == "b":
        buf = rng.random(m) < 0.5
        vals = rng.random(n_upd) < 0.5
    else:
        info = np.iinfo(dt)
        buf = rng.integers(info.min, info.max, m, dtype=dt,
                           endpoint=True)
        vals = rng.integers(info.min, info.max, n_upd, dtype=dt,
                            endpoint=True)
    idx = rng.choice(m, n_upd, replace=False)
    idx_p, vals_p, bucket = resident._pad_updates(idx, vals)
    return buf, idx_p, vals_p, bucket


@pytest.mark.parametrize("dtype", SCATTER_DTYPES)
def test_delta_scatter_plain_matches_reference_bytes(dtype):
    """Bit for bit against _delta_scatter_program, with the padding's
    duplicate indices, on 2-D tables (the scatter flattens them)."""
    if dtype == "float16":
        pytest.importorskip("jax")
    for m_shape, n_upd, seed in (((4, 256), 3, 0), ((8, 512), 100, 1),
                                 ((1, 64), 64, 2)):
        m = int(np.prod(m_shape))
        buf, idx_p, vals_p, bucket = _scatter_case(dtype, m, n_upd, seed)
        buf = buf.reshape(m_shape)
        assert (idx_p[n_upd:] == idx_p[0]).all()
        prog = constcache._delta_scatter_program(m_shape, buf.dtype.str,
                                                 bucket)
        want = np.asarray(prog(buf, idx_p, vals_p))
        got = resident.delta_scatter(torch.from_numpy(buf.copy()),
                                     torch.from_numpy(idx_p),
                                     torch.from_numpy(vals_p))
        assert same_bytes(host(got), want), (dtype, m_shape)
        # the base is never written
        assert same_bytes(buf, buf.copy())


def test_delta_scatter_never_writes_its_base_and_drops_out_of_range():
    base = torch.arange(16, dtype=torch.float32)
    keep = base.clone()
    idx = torch.tensor([3, 99, -1, 3, 3, 3, 3, 3], dtype=torch.int32)
    vals = torch.tensor([-0.0, 7, 8, -0.0, -0.0, -0.0, -0.0, -0.0])
    out = resident.delta_scatter(base, idx, vals)
    assert torch.equal(base, keep)
    want = keep.clone()
    want[3] = -0.0
    assert same_bytes(host(out), host(want))
    assert out.data_ptr() != base.data_ptr()


def test_delta_scatter_checks_its_arguments():
    buf = torch.zeros(8)
    idx = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(TypeError):
        resident.delta_scatter(buf, idx.long(), torch.zeros(8))
    with pytest.raises(TypeError):
        resident.delta_scatter(buf, idx, torch.zeros(8, dtype=torch.float64))
    with pytest.raises(ValueError):
        resident.delta_scatter(buf[::2], idx[:4], torch.zeros(4))


# ----------------------------------------------------------------------
# the content cache (tests/test_constcache.py, ported)


def arr(fill, n=4096, dtype=np.float32):
    return np.full(n, fill, dtype=dtype)


def put(arrays, **kw):
    return resident.device_put_cached(arrays, device=CPU, **kw)


def test_hit_miss_and_byte_accounting():
    a, b = arr(1.0), arr(2.0)
    bufs1, shipped1 = put([a, b], version=7)
    assert shipped1 == a.nbytes + b.nbytes
    bufs2, shipped2 = put([arr(1.0), arr(2.0)], version=7)
    assert shipped2 == 0
    st = resident.stats()
    assert st["hits"] == 2 and st["misses"] == 2
    assert st["bytes_saved_total"] == a.nbytes + b.nbytes
    assert st["bytes_shipped_total"] == shipped1
    assert st["resident_bytes"] == a.nbytes + b.nbytes
    assert bufs2[0] is bufs1[0] and bufs2[1] is bufs1[1]
    assert (host(bufs2[0]) == a).all()
    # the resident copy owns its memory (never an alias of the source)
    assert bufs1[0].data_ptr() != a.ctypes.data


def test_small_arrays_ship_fresh():
    small = np.arange(8, dtype=np.int32)
    _, s1 = put([small])
    _, s2 = put([small])
    assert s1 == s2 == small.nbytes
    assert resident.stats()["entries"] == 0


def test_cacheable_mask_excludes_delta_buffers():
    a, b = arr(3.0), arr(4.0)
    put([a, b], cacheable=[True, False])
    assert resident.stats()["entries"] == 1
    _, shipped = put([a, b], cacheable=[True, False])
    assert shipped == b.nbytes


def test_lru_bound(monkeypatch):
    monkeypatch.setenv("NOMAD_TPU_TORCH_CONST_CACHE_ENTRIES", "2")
    for i in range(4):
        put([arr(float(i))])
    st = resident.stats()
    assert st["entries"] == 2 and st["evictions"] == 2
    _, shipped = put([arr(3.0)])
    assert shipped == 0


def test_byte_bound(monkeypatch):
    monkeypatch.setenv("NOMAD_TPU_TORCH_CONST_CACHE_MB",
                       str(2.5 * 16384 / 2 ** 20))
    for i in range(4):
        put([arr(float(i))])
    st = resident.stats()
    assert st["entries"] == 2 and st["resident_bytes"] == 2 * 16384


def test_kill_switch(monkeypatch):
    monkeypatch.setenv("NOMAD_TPU_TORCH_CONST_CACHE", "0")
    a = arr(9.0)
    _, s1 = put([a])
    bufs, s2 = put([a])
    assert s1 == s2 == a.nbytes
    st = resident.stats()
    assert st["entries"] == 0 and st["enabled"] is False
    assert st["delta_stream_enabled"] is False
    assert (host(bufs[0]) == a).all()


def test_node_table_write_drops_stale_versions():
    put([arr(1.0)], version=5)
    put([arr(2.0)], version=9)
    resident.note_node_table_write(9)
    st = resident.stats()
    assert st["entries"] == 1 and st["invalidations"] == 1
    _, shipped = put([arr(2.0)], version=9)
    assert shipped == 0


def test_state_store_write_invalidates_through_the_hook():
    store = StateStore()
    idx = store.upsert_node(_Alloc("n1", None))
    put([arr(1.0)], version=idx)
    store.upsert_node(_Alloc("n2", None))
    assert resident.stats()["entries"] == 0
    # alloc writes leave the content cache alone
    put([arr(1.0)], version=store.latest_index())
    store.upsert_allocs([_Alloc("a1", "n1")])
    assert resident.stats()["entries"] == 1


def test_invalidate_all():
    put([arr(1.0)], version=1)
    put_chain([table(1)], FakeStore(), token=1)
    resident.invalidate_all("test")
    st = resident.stats()
    assert st["entries"] == 0 and st["resident_bytes"] == 0
    assert st["chain_entries"] == 0 and st["chain_resident_bytes"] == 0
    assert st["invalidations"] == 1


def test_fused_dispatch_ships_fewer_bytes_warm():
    """A dense lane dispatched twice: the second ships at most half the
    bytes (its const buffers resident), with identical results; a
    node-table write then drops them."""
    from nomad_tpu_torch.solver.batch import fuse_and_solve
    lane, store = _tiny_dense_lane()
    before = resident.stats()["bytes_shipped_total"]
    cold = fuse_and_solve([lane], device="cpu")
    mid = resident.stats()["bytes_shipped_total"]
    warm = fuse_and_solve([lane], device="cpu")
    after = resident.stats()["bytes_shipped_total"]
    assert (cold[0][0] == warm[0][0]).all()
    assert mid - before > 0
    assert (after - mid) * 2 <= mid - before, (mid - before, after - mid)
    store.upsert_node(_Alloc("extra-node", None))
    assert resident.stats()["resident_bytes"] == 0


def _tiny_dense_lane():
    from nomad_tpu_torch.solver.service import pack_lane_arrays
    from nomad_tpu_torch.tensor.pack import NodeMatrix, UsageState
    n, n_pad = 24, 1024
    store = StateStore()
    for i in range(n):
        store.upsert_node(_Alloc(f"cc-node-{i:04d}", None))
    matrix = NodeMatrix(
        n_real=n, n_pad=n_pad, node_ids=[f"cc-node-{i:04d}"
                                         for i in range(n)],
        cpu_cap=np.r_[np.full(n, 4000.0), np.zeros(n_pad - n)],
        mem_cap=np.r_[np.full(n, 8192.0), np.zeros(n_pad - n)],
        disk_cap=np.r_[np.full(n, 102400.0), np.zeros(n_pad - n)],
        dyn_free=np.full(n_pad, 100, dtype=np.int32),
        valid=np.arange(n_pad) < n)
    z = np.zeros(n_pad)
    zi = np.zeros(n_pad, dtype=np.int32)
    lane = pack_lane_arrays(
        matrix, UsageState(z, z, z, zi, zi, zi), np.ones(n_pad, bool),
        ask=(500.0, 256.0, 150.0), count=6, n_places=6, eval_id="cc-eval",
        state_index=store.latest_index(), affinity=np.zeros(n_pad),
        table_version=store.table_index("nodes"),
        delta_src=(store, store.latest_index()), device="cpu")
    lane.batch = lane.batch._replace(
        ask_cpu=np.array([500.0, 600.0] * 3))
    lane._wave = None
    assert not lane.wavefront_ok()
    return lane, store


# ----------------------------------------------------------------------
# the version chain (tests/test_delta_stream.py, ported)


def table(seed=0, shape=(8, 256)):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape).astype(np.float32)
    assert a.nbytes >= resident._min_bytes()
    return a


class FakeStore:
    """Programmable journal: (covered, pairs) per call."""

    def __init__(self, covered=True, pairs=()):
        self.covered = covered
        self.pairs = list(pairs)
        self.calls = []

    def alloc_deltas_since(self, index, upto=None):
        self.calls.append((index, upto))
        return self.covered, list(self.pairs)


def put_chain(arrs, store, token, tags=None):
    return resident.device_put_cached(
        [np.array(a) for a in arrs], device=CPU, version=token,
        cacheable=[False] * len(arrs),
        tags=tags or ["compact"] * len(arrs), delta_src=(store, token))


def test_bitwise_diff_is_bytewise_not_value_equality():
    old = np.array([0.0, 1.0, np.nan, 2.0], dtype=np.float32)
    new = old.copy()
    assert resident._bitwise_changed(old, new).size == 0
    new[0] = -0.0
    new[2] = np.float32(np.nan)
    assert resident._bitwise_changed(old, new).tolist() == [0]
    new2 = old.copy()
    new2.view(np.uint32)[2] ^= 1
    assert resident._bitwise_changed(old, new2).tolist() == [2]


@pytest.mark.parametrize("n,bucket", [(3, 8), (8, 8), (9, 16), (100, 128)])
def test_pad_updates_pow2_bucket_min8_duplicates_slot0(n, bucket):
    idx = np.arange(3, 3 + n, dtype=np.int64)
    vals = np.arange(n, dtype=np.float32) + 1.0
    idx_p, vals_p, b = resident._pad_updates(idx, vals)
    assert b == bucket and idx_p.size == vals_p.size == bucket
    assert idx_p.dtype == np.int32
    assert set(idx_p[n:].tolist()) <= {3}
    assert set(vals_p[n:].tolist()) <= {1.0}
    ref = constcache._pad_updates(idx, vals)
    assert same_bytes(idx_p, ref[0]) and same_bytes(vals_p, ref[1])


def test_install_reuse_promote_sequence_bitwise_exact():
    store = FakeStore(covered=True)
    a = table(seed=1)
    bufs, shipped = put_chain([a], store, token=10)
    assert shipped == a.nbytes
    st = resident.stats()
    assert st["chain_entries"] == 1 and st["delta_fallbacks"] == 0

    bufs, shipped = put_chain([a], store, token=11)
    assert shipped == 0
    assert resident.stats()["delta_reuses"] == 1
    np.testing.assert_array_equal(host(bufs[0]), a)

    b = a.copy()
    b[0, 3] = -0.0
    b[5, 100] = np.float32(7.25)
    before = bufs[0].clone()
    base = bufs[0]
    bufs, shipped = put_chain([b], store, token=12)
    st = resident.stats()
    assert st["delta_promotions"] == 1 and st["delta_fallbacks"] == 0
    assert 0 < shipped < b.nbytes // 4
    assert same_bytes(host(bufs[0]), b)
    # the promotion wrote a new buffer; the base is untouched
    assert bufs[0].data_ptr() != base.data_ptr()
    assert torch.equal(base, before)
    row = [r for r in resident.residency()
           if r["id"].startswith("chain:")][0]
    assert row["version"] == 12 and row["deltas_applied"] == 1
    assert row["base_version"] == 10


@pytest.mark.parametrize("failure", ["uncovered", "raises"])
def test_journal_that_cannot_vouch_is_a_counted_gap(failure):
    """An uncovered span, or a journal that raises, re-ships wholesale as
    a counted gap, never wrong; the slot re-installs at the new token."""
    class Exploding(FakeStore):
        def alloc_deltas_since(self, index, upto=None):
            raise RuntimeError("journal on fire")

    store = FakeStore(covered=True)
    a = table(seed=2)
    put_chain([a], store, token=1)
    if failure == "uncovered":
        store.covered = False
        bad = store
    else:
        bad = Exploding()
    b = a.copy()
    b[2, 2] += 1.0
    bufs, shipped = put_chain([b], bad, token=2)
    st = resident.stats()
    assert st["delta_fallbacks"] == 1 and st["delta_gap_fallbacks"] == 1
    assert shipped == b.nbytes
    np.testing.assert_array_equal(host(bufs[0]), b)
    store.covered = True
    c = b.copy()
    c[0, 0] += 1.0
    bufs, _ = put_chain([c], store, token=3)
    assert resident.stats()["delta_promotions"] == 1
    np.testing.assert_array_equal(host(bufs[0]), c)


def test_oversized_diff_is_counted_size_fallback(monkeypatch):
    monkeypatch.setenv("NOMAD_TPU_TORCH_DELTA_MAX_FRAC", "0.25")
    store = FakeStore(covered=True)
    a = table(seed=3)
    put_chain([a], store, token=1)
    b = a + 1.0
    bufs, shipped = put_chain([b], store, token=2)
    st = resident.stats()
    assert st["delta_size_fallbacks"] == 1 and st["delta_bytes_total"] == 0
    assert shipped == b.nbytes
    np.testing.assert_array_equal(host(bufs[0]), b)


def _alloc_world():
    store = StateStore()
    nodes = [_Alloc(f"ds-node-{k:04d}", None) for k in range(2)]
    for n in nodes:
        store.upsert_node(n)
    return store, nodes


@pytest.mark.parametrize("writes,outcome", [(12, "gap"), (3, "promote")])
def test_journal_span_on_real_store(monkeypatch, writes, outcome):
    """More alloc writes than a journal of 8 holds between two sightings
    of a slot: a counted wholesale gap; a few writes inside it: a
    promotion. Bitwise right either way."""
    monkeypatch.setenv("NOMAD_TPU_TORCH_DELTA_JOURNAL", "8")
    store, nodes = _alloc_world()
    a = table(seed=5)
    put_chain([a], store, token=store.latest_index())
    for i in range(writes):
        store.upsert_allocs([_Alloc(f"al-{i}", nodes[i % 2].id)])
    b = a.copy()
    b[1, 1] += 1.0
    bufs, shipped = put_chain([b], store, token=store.latest_index())
    st = resident.stats()
    if outcome == "gap":
        assert st["delta_gap_fallbacks"] == 1
        assert st["delta_promotions"] == 0 and shipped == b.nbytes
        assert store.delta_journal_overflow == 1
    else:
        assert st["delta_promotions"] == 1 and st["delta_fallbacks"] == 0
        assert st["delta_touched_nodes_last"] == 2
    np.testing.assert_array_equal(host(bufs[0]), b)


def test_delta_less_write_is_a_gap():
    """A whole-table replacement journals no change pairs: the chain must
    refuse to delta across it."""
    store, nodes = _alloc_world()
    store.upsert_allocs([_Alloc("al-0", nodes[0].id)])
    a = table(seed=7)
    put_chain([a], store, token=store.latest_index())
    store.replace_allocs(store.allocs())
    b = a.copy()
    b[0, 1] += 2.0
    bufs, shipped = put_chain([b], store, token=store.latest_index())
    st = resident.stats()
    assert st["delta_gap_fallbacks"] == 1 and st["delta_promotions"] == 0
    assert shipped == b.nbytes
    np.testing.assert_array_equal(host(bufs[0]), b)


def test_kill_switch_disables_chain_bitwise_parity(monkeypatch):
    gens = [table(seed=8)]
    g = gens[0].copy()
    g[3, 33] = -0.0
    gens.append(g)
    g2 = g.copy()
    g2[7, 200] = np.float32(np.inf)
    gens.append(g2)
    store = FakeStore(covered=True)
    on = []
    for t, a in enumerate(gens):
        bufs, _ = put_chain([a], store, token=t + 1)
        on.append(host(bufs[0]))
    assert resident.stats()["delta_promotions"] >= 1
    resident._reset_for_tests()
    monkeypatch.setenv("NOMAD_TPU_TORCH_DELTA_STREAM", "0")
    assert not resident.delta_stream_enabled()
    off = []
    for t, a in enumerate(gens):
        bufs, shipped = put_chain([a], store, token=t + 1)
        assert shipped == a.nbytes
        off.append(host(bufs[0]))
    st = resident.stats()
    assert st["chain_entries"] == 0
    assert st["delta_promotions"] == 0 and st["delta_reuses"] == 0
    for x, y in zip(on, off):
        assert same_bytes(x, y)


def test_promoted_shadow_is_frozen_and_buffers_match_it():
    store = FakeStore(covered=True)
    a = table(seed=10)
    put_chain([a], store, token=1)
    b = a.copy()
    b[1, 2] = np.float32(np.nan)
    put_chain([b], store, token=2)
    with resident._LOCK:
        ce = next(iter(resident._CHAIN.values()))
    with pytest.raises(ValueError):
        ce.host[0, 0] = 123.0
    for buf, shadow in resident.chain_entries():
        assert same_bytes(host(buf), shadow)


def test_slot_keys_follow_tag_dtype_shape_and_occurrence():
    """Two same-shaped arrays in one call are two slots; a call that
    repeats them reuses each against its own slot."""
    store = FakeStore(covered=True)
    a, b = table(seed=11), table(seed=12)
    put_chain([a, b], store, token=1)
    bufs, shipped = put_chain([a, b], store, token=2)
    assert shipped == 0 and resident.stats()["delta_reuses"] == 2
    ids = sorted(r["id"] for r in resident.residency())
    assert ids == ["chain:compact/<f4/8x256#0", "chain:compact/<f4/8x256#1"]


# ----------------------------------------------------------------------
# one generation sequence through both packages' solve_lane_fused

N_NODES = 48


@pytest.fixture(scope="module")
def gen_world():
    """A reference scheduler world: a fleet partly filled by a priority-20
    job's allocs (real upsert_allocs), and lanes the reference packs for
    every route: two plain lanes (one wave group), a spread lane at count
    140 (dense), a priority-90 preemption lane (windowed) and one with a
    spread (dense preemption)."""
    from nomad_tpu.scheduler import Harness
    from nomad_tpu.scheduler.context import EvalContext
    from nomad_tpu.scheduler.reconcile import AllocPlaceResult
    from nomad_tpu.solver.service import TpuPlacementService
    from nomad_tpu.structs import Plan, Spread

    rng = random.Random(17)
    h = Harness()
    nodes = []
    for i in range(N_NODES):
        n = mock.node()
        n.id = f"res-node-{i:04d}"
        n.node_resources.cpu.cpu_shares = (2000, 4000, 8000)[i % 3]
        n.node_resources.memory.memory_mb = (4096, 8192, 16384)[i % 3]
        n.meta["rack"] = f"r{i % 5}"
        n.compute_class()
        nodes.append(n)
        h.state.upsert_node(n)
    filler = mock.job(id="res-filler")
    filler.priority = 20
    h.state.upsert_job(filler)
    h.state.upsert_allocs([mock.alloc_for(filler, nodes[k], index=k)
                           for k in range(0, N_NODES, 2)])
    snap = h.state.snapshot()
    specs = [("plain", 20, 50, False), ("plain", 24, 50, False),
             ("spread", 140, 50, False), ("preempt", 6, 90, True),
             ("preempt_spread", 6, 90, True)]
    lanes = []
    for i, (kind, count, prio, pre) in enumerate(specs):
        job = mock.job(id=f"res-job-{i}")
        job.priority = prio
        tg = job.task_groups[0]
        tg.count = count
        if kind == "spread":
            tg.tasks[0].resources.cpu = 100
            tg.tasks[0].resources.memory_mb = 64
        if "spread" in kind:
            tg.spreads = [Spread(attribute="${meta.rack}", weight=50)]
        if pre:
            tg.tasks[0].resources.cpu = rng.choice([1500, 2500])
        h.state.upsert_job(job)
        plan = Plan(eval_id=f"res-eval-{i:027d}", priority=prio, job=job)
        ctx = EvalContext(snap, plan)
        places = [AllocPlaceResult(name=f"{job.id}.{tg.name}[{k}]",
                                   task_group=tg) for k in range(count)]
        svc = TpuPlacementService(ctx, job, batch_mode=False,
                                  spread_alg=False, preempt=pre)
        lane = svc.pack(tg, places, nodes)
        assert lane is not None and lane.delta_src is not None
        lanes.append(lane)
    waves = [ln.wavefront_ok() for ln in lanes]
    assert waves == [True, True, False, True, False], waves
    assert lanes[3].ptab is not None and lanes[4].ptab is not None
    return h, nodes, filler, lanes


def _carry(lanes):
    from nomad_tpu_torch.carry import lane_from_reference
    return [lane_from_reference(
        ln.const, ln.init, ln.batch, ln.order, dtype_name=ln.dtype_name,
        spread_alg=ln.spread_alg, node_ids=ln.matrix.node_ids,
        ptab=ln.ptab, pinit=ln.pinit, table_version=ln.table_version,
        delta_src=ln.delta_src, device="cpu") for ln in lanes]


def _dispatch_both(ref_lanes):
    """Every fused group once through each package's solve_lane_fused,
    the arena entries returned to both pools afterwards (group sizes off
    the E buckets: tests/test_torch_arena.py)."""
    from nomad_tpu.solver.batch import _ARENA as ref_arena
    from nomad_tpu.solver.batch import fuse_lanes as ref_fuse_lanes
    from nomad_tpu.solver.binpack import solve_lane_fused as ref_solve
    from nomad_tpu_torch.solver.batch import fuse_lanes, release_groups
    from nomad_tpu_torch.solver.wave import solve_lane_fused

    ref_groups = ref_fuse_lanes(ref_lanes)
    port_groups = fuse_lanes(_carry(ref_lanes))
    assert [g.idxs for g in ref_groups] == [g.idxs for g in port_groups]
    outs = []
    for rg, pg in zip(ref_groups, port_groups):
        want = ref_solve(rg.const, rg.init, rg.batch, rg.ptab, rg.pinit,
                         spread_alg=rg.spread_alg, dtype_name=rg.dtype_name,
                         batched=True, wave=rg.wave,
                         cache_version=rg.cache_version,
                         delta_src=rg.delta_src)
        got = solve_lane_fused(pg.const, pg.init, pg.batch, pg.ptab,
                               pg.pinit, spread_alg=pg.spread_alg,
                               dtype_name=pg.dtype_name, wave=pg.wave,
                               device="cpu", cache_version=pg.cache_version,
                               delta_src=pg.delta_src)
        outs.append((want, got))
    for rg in ref_groups:
        ref_arena.release(rg.entry)
    release_groups(port_groups)
    return outs


STAT_KEYS = ("hits", "misses", "bytes_shipped_total", "bytes_saved_total",
             "delta_promotions", "delta_reuses", "delta_fallbacks",
             "delta_gap_fallbacks", "delta_size_fallbacks",
             "delta_bytes_total", "delta_touched_nodes_last",
             "resident_bytes", "chain_resident_bytes", "entries",
             "chain_entries")


def _assert_outputs_equal(outs):
    for want, got in outs:
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[2], want[2])
        np.testing.assert_allclose(got[1], want[1], rtol=1e-12)
        if len(want) == 4:
            np.testing.assert_array_equal(got[3], np.asarray(want[3]))


def _charge(lanes, k, nodes_pos, ask):
    """Charge ``ask`` at shuffled positions ``nodes_pos`` of lane k's
    usage tables, in place (a committed placement's footprint)."""
    init = lanes[k].init
    for f, a in zip(("used_cpu", "used_mem", "used_disk"), ask):
        getattr(init, f)[nodes_pos] += a


def _set_token(lanes, store):
    for ln in lanes:
        ln.delta_src = (store, store.latest_index())


def test_generation_sequence_matches_reference(gen_world):
    """install -> reuse/hit -> promote -> gap, the four routes at once:
    every generation's decisions equal, the resident sets' counters equal
    the reference's after every generation, and every chain buffer equals
    its frozen shadow."""
    h, nodes, filler, lanes = gen_world
    import copy
    lanes = [copy.copy(ln) for ln in lanes]
    for ln in lanes:
        ln.init = type(ln.init)(*(np.array(a) for a in ln.init))
    store = h.state
    seen = []

    def generation():
        outs = _dispatch_both(lanes)
        _assert_outputs_equal(outs)
        want, got = constcache.stats(), resident.stats()
        for k in STAT_KEYS:
            assert got[k] == want[k], (k, got[k], want[k], len(seen))
        for buf, shadow in resident.chain_entries():
            assert same_bytes(host(buf), shadow)
        seen.append(dict(got))

    # g1: cold -- every array installs or misses
    generation()
    assert seen[0]["delta_reuses"] == seen[0]["delta_promotions"] == 0
    assert seen[0]["chain_entries"] > 0
    # g2: the same tables at a newer journal index (one covered write)
    store.upsert_allocs([mock.alloc_for(filler, nodes[1], index=900)])
    _set_token(lanes, store)
    generation()
    assert seen[1]["delta_reuses"] > 0 and seen[1]["hits"] > 0
    assert seen[1]["delta_fallbacks"] == 0
    # g3: a small covered commit charged into the dense and wave lanes
    store.upsert_allocs([mock.alloc_for(filler, nodes[k], index=910 + k)
                         for k in (3, 5)])
    _set_token(lanes, store)
    for k in (0, 2):
        _charge(lanes, k, [3, 5], (100.0, 64.0, 150.0))
    generation()
    assert seen[2]["delta_promotions"] > 0
    assert seen[2]["delta_touched_nodes_last"] >= 1
    # g4: a write with no change pairs, then another small charge: gap
    with store._lock:
        store._bump("allocs")
    _set_token(lanes, store)
    _charge(lanes, 2, [7], (100.0, 64.0, 150.0))
    generation()
    assert seen[3]["delta_gap_fallbacks"] > 0


def test_kill_switches_keep_decisions(gen_world, monkeypatch):
    """With the chain off, and with the whole resident set off, the port's
    decisions equal the reference's; with the set off nothing is
    counted."""
    h, nodes, filler, lanes = gen_world
    monkeypatch.setenv("NOMAD_TPU_TORCH_DELTA_STREAM", "0")
    _assert_outputs_equal(_dispatch_both(lanes))
    assert resident.stats()["chain_entries"] == 0
    resident._reset_for_tests()
    monkeypatch.setenv("NOMAD_TPU_TORCH_CONST_CACHE", "0")
    _assert_outputs_equal(_dispatch_both(lanes))
    st = resident.stats()
    assert st["entries"] == st["chain_entries"] == 0
    assert st["bytes_shipped_total"] == 0


def test_promotions_ship_one_staged_payload_each(gen_world, monkeypatch):
    """Each promotion ships its padded (idx, vals) payload as one staged
    buffer (one host->device copy on a card): the payloads equal, in
    order, the ones the reference's _scatter_single ships in its one
    device_put, and the counters equal the reference's."""
    h, nodes, filler, lanes = gen_world
    import copy
    lanes = [copy.copy(ln) for ln in lanes]
    for ln in lanes:
        ln.init = type(ln.init)(*(np.array(a) for a in ln.init))
    store = h.state
    staged, shipped = [], []
    real_stage, real_ref = resident._stage_payload, constcache._scatter_single

    def stage(idx_p, vals_p, pinned):
        host_buf, off = real_stage(idx_p, vals_p, pinned)
        n = idx_p.size
        staged.append((host_buf[:4 * n].view(torch.int32).numpy().copy(),
                       host_buf[off:].numpy().copy()))
        return host_buf, off

    def ref_scatter(buf, shape, dtype_str, idx_p, vals_p):
        shipped.append((np.array(idx_p),
                        np.ascontiguousarray(vals_p).view(np.uint8).copy()))
        return real_ref(buf, shape, dtype_str, idx_p, vals_p)

    monkeypatch.setattr(resident, "_stage_payload", stage)
    monkeypatch.setattr(constcache, "_scatter_single", ref_scatter)
    _set_token(lanes, store)
    for gen in range(3):
        if gen:
            k = 20 + gen
            store.upsert_allocs([mock.alloc_for(filler, nodes[k],
                                                index=960 + gen)])
            _set_token(lanes, store)
            for li in (0, 2):
                _charge(lanes, li, [k], (100.0, 64.0, 150.0))
        _assert_outputs_equal(_dispatch_both(lanes))
        want, got = constcache.stats(), resident.stats()
        for key in STAT_KEYS:
            assert got[key] == want[key], (key, got[key], want[key], gen)
        assert len(staged) == got["delta_promotions"]
    assert len(staged) == len(shipped) > 0
    for (idx, vals), (ridx, rvals) in zip(staged, shipped):
        np.testing.assert_array_equal(idx, ridx)
        np.testing.assert_array_equal(vals, rvals)
    for buf, shadow in resident.chain_entries():
        assert same_bytes(host(buf), shadow)
