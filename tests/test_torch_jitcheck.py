"""The port's dispatch-discipline sanitizer (nomad_tpu_torch/jitcheck.py)
on the CPU: the reference's own tests (tests/test_jitcheck.py, less the
HTTP and CLI surfaces and the weak-typed scalar, which a ctypes launch
has no counterpart of), each planted fault found, the same verdict as
the reference's checker on the mirrored scenarios, and no sync call in
any CUDA launcher."""
import re
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from nomad_tpu import jitcheck as ref_jitcheck
from nomad_tpu_torch import jitcheck, kernels, schedcheck
from nomad_tpu_torch.solver import batch, dense, guard, resident
from nomad_tpu_torch.solver.service import dispatch_lane
from nomad_tpu_torch.tensor import pack as tpack

from test_dispatch_pipeline import build_world, pack_lane
from test_torch_barrier import _carry

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _clean_checker():
    """Every test leaves the original Tensor methods restored and both
    packages' checker state empty, pass or fail."""
    batch.arena_clear("jitcheck test")
    resident._reset_for_tests()
    yield
    jitcheck.disable()
    jitcheck._reset_for_tests()
    ref_jitcheck.disable()
    ref_jitcheck._reset_for_tests()
    tpack.reset_pack_caches()
    batch.arena_clear("jitcheck test teardown")
    resident._reset_for_tests()


def _lane(i=0, n_nodes=8, count=4):
    h, nodes = build_world(n_nodes)
    return _carry([pack_lane(h, nodes, i, count=count)])[0]


def _pristine():
    return all(
        getattr(torch.Tensor, n) is schedcheck._PRISTINE.get(
            (torch.Tensor, n), (getattr(torch.Tensor, n),))[0]
        and not getattr(getattr(torch.Tensor, n), "_jitcheck_wrapped",
                        False)
        for n in jitcheck._FETCH_FORMS) \
        and warnings.showwarning is not jitcheck._showwarning


# ----------------------------------------------------------------------
# kill switch + parity


def test_killswitch_is_inert(monkeypatch):
    """NOMAD_TPU_TORCH_JITCHECK=0 (or unset) is a true no-op: the Tensor
    fetch forms are the originals and nothing records."""
    monkeypatch.setenv("NOMAD_TPU_TORCH_JITCHECK", "0")
    before = {n: getattr(torch.Tensor, n) for n in jitcheck._FETCH_FORMS}
    jitcheck.maybe_install_from_env()
    assert not jitcheck.enabled()
    assert {n: getattr(torch.Tensor, n)
            for n in jitcheck._FETCH_FORMS} == before
    assert _pristine()
    guard.run_dispatch(lambda: float(torch.tensor(1.5)), timeout_s=5.0,
                       device="cpu")
    st = jitcheck.state()
    assert st["enabled"] is False and st["host_sync_count"] == 0


def test_env_knob_installs(monkeypatch):
    monkeypatch.setenv("NOMAD_TPU_TORCH_JITCHECK", "1")
    before = torch.Tensor.item
    jitcheck.maybe_install_from_env()
    assert jitcheck.enabled()
    assert torch.Tensor.item is not before
    assert torch.Tensor.item._jitcheck_wrapped
    jitcheck.disable()
    assert torch.Tensor.item is before
    assert "item" not in vars(torch.Tensor)      # inherited, as it was
    assert _pristine()


def test_enabled_solve_is_bitwise_identical():
    """The same solo dispatch with the checker recording returns bit for
    bit what the raw path returns, with no hot sync and no rebuild."""
    off = dispatch_lane(_lane(0), device="cpu")
    jitcheck.enable()
    try:
        on = dispatch_lane(_lane(0), device="cpu")
        st = jitcheck.state()
    finally:
        jitcheck.disable()
    for a, b in zip(off, on):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert st["rebuilds"] == [] and st["host_syncs"] == []


# ----------------------------------------------------------------------
# steady-state rebuilds


class _FakeLib:
    """An entry point table standing in for a built kernel library."""

    def __init__(self):
        def sym(*a):
            return 0
        self.nt_fake_f32 = sym


def test_rebinding_one_signature_is_a_rebuild():
    """THE bug class: a kernel whose entry-point cache is dropped per call
    binds the same (library, dtype) again -- a steady-state rebuild, with
    its count and site."""
    from nomad_tpu_torch.server.telemetry import metrics
    metrics.reset()
    jitcheck.enable()
    k = kernels.Kernel("fake", "fake.cu", "test", {torch.float32:
                                                    "nt_fake_f32"})
    k.bind(_FakeLib())
    for _ in range(3):
        k._fns = {}               # the bug: the cache does not survive
        k._fn(torch.float32)
    st = jitcheck.state(sites=True)
    assert st["rebuild_count"] == 1
    rep = st["rebuilds"][0]
    assert rep["count"] == 2 and rep["site"] == "kernel:fake"
    assert "test_torch_jitcheck.py" in rep["stack"]
    assert metrics.snapshot()["counters"].get(
        "nomad.jitcheck.rebuild", 0) >= 1
    # bind() (the A/B use) starts a fresh table: not a rebuild
    k.bind(_FakeLib())
    k._fn(torch.float32)
    assert jitcheck.state()["rebuild_count"] == 1
    metrics.reset()


def test_arena_holds_one_build_per_bucket():
    """The arena builds each (bucket, dtypes) once: repeated checkouts
    reuse it; a second bucket is one more build, late (the site went
    steady), and no rebuild."""
    jitcheck.enable()
    specs4 = {"t": [((4, 8), np.float32)]}
    specs8 = {"t": [((8, 8), np.float32)]}
    for _ in range(3):
        ent, _ = batch._ARENA.acquire(("jck", 4), specs4)
        batch._ARENA.release(ent)
    for _ in range(3):
        ent, _ = batch._ARENA.acquire(("jck", 8), specs8)
        batch._ARENA.release(ent)
    st = jitcheck.state(sites=True)
    assert st["rebuild_count"] == 0, st["rebuilds"]
    site = [s for s in st["sites"] if s["site"] == batch._ARENA_SITE][0]
    assert site["builds"] == 2 and site["sigs"] == 2 and site["steady"]
    assert st["late_build_count"] == 1


def test_arena_rebuild_planted(monkeypatch):
    """An arena whose free-list match is broken allocates a bucket it
    holds: reported as a rebuild."""
    jitcheck.enable()
    specs = {"t": [((4, 8), np.float32)]}
    ent, _ = batch._ARENA.acquire(("jck", 4), specs)
    batch._ARENA.release(ent)
    real = batch._StackArena._specs_match
    calls = {"n": 0}

    def broken(ent, specs):
        calls["n"] += 1
        # the checkout's lookup misses (the planted bug); the rebuild
        # check's own lookup sees the held entry
        return real(ent, specs) and calls["n"] > 1

    monkeypatch.setattr(batch._StackArena, "_specs_match",
                        staticmethod(broken))
    ent2, reused = batch._ARENA.acquire(("jck", 4), specs)
    assert not reused
    st = jitcheck.state()
    assert st["rebuild_count"] == 1, st["rebuilds"]
    batch._ARENA.release(ent2)


def test_real_barrier_steady_state():
    """Two generations of the same lanes through fuse_and_solve build the
    arena's stacks once; a new placement bucket adds one build and no
    rebuild."""
    h, nodes = build_world(16)
    lanes = _carry([pack_lane(h, nodes, i) for i in range(2)])
    jitcheck.enable()
    batch.fuse_and_solve(lanes, device="cpu")
    st1 = jitcheck.state()
    batch.fuse_and_solve(lanes, device="cpu")
    st2 = jitcheck.state()
    assert st2["rebuild_count"] == 0, st2["rebuilds"]
    assert st2["builds"] == st1["builds"]
    big = _carry([pack_lane(h, nodes, 9, count=40)])
    batch.fuse_and_solve(big, device="cpu")
    st3 = jitcheck.state()
    assert st3["rebuild_count"] == 0, st3["rebuilds"]
    assert st3["builds"] > st2["builds"]


# ----------------------------------------------------------------------
# hot-path host syncs


def test_unsanctioned_item_in_a_dispatch_detected_and_attributed():
    from nomad_tpu_torch.server.tracing import tracer
    jitcheck.enable()

    def syncs():
        return torch.tensor([3.25]).sum().item()

    eid = "jck-eval-" + "0" * 22
    ctx = tracer.begin(eid, job="jck")
    with tracer.activate(ctx):
        assert guard.run_dispatch(syncs, label="solver.test",
                                  timeout_s=5.0, device="cpu") == 3.25
    tracer.end(eid, status="complete")
    st = jitcheck.state()
    assert st["host_sync_count"] == 1
    rep = st["host_syncs"][0]
    assert rep["kind"] == "item"
    assert rep["label"] == "solver.test"
    assert "test_torch_jitcheck.py" in rep["site"]
    assert eid in rep["evals"]


@pytest.mark.parametrize("form", ["__float__", "__int__", "__bool__",
                                  "__index__", "tolist", "cpu", "numpy"])
def test_every_fetch_form_is_caught(form):
    jitcheck.enable()
    t = torch.ones(1, dtype=torch.int64)
    calls = {"__float__": lambda: float(t), "__int__": lambda: int(t),
             "__bool__": lambda: bool(t), "__index__": lambda: [0, 1][t],
             "tolist": t.tolist, "cpu": t.cpu, "numpy": t.numpy}
    guard.run_dispatch(calls[form], timeout_s=5.0, device="cpu")
    st = jitcheck.state()
    assert [r["kind"] for r in st["host_syncs"]] == [form]


def test_to_the_host_is_a_fetch_only_from_a_card():
    """``.to()`` onto the CPU reads back from a card; on a CPU cell it
    is the form of an upload onto the cell's own device."""
    jitcheck.enable()
    guard.run_dispatch(lambda: torch.ones(2).to("cpu"), timeout_s=5.0,
                       device="cpu")
    assert jitcheck.state()["host_sync_count"] == 0
    assert jitcheck._cpu_target(("cpu",), {})
    assert jitcheck._cpu_target((), {"device": torch.device("cpu")})
    assert not jitcheck._cpu_target((torch.float32,), {})


def test_sanctioned_fetch_is_not_a_violation():
    jitcheck.enable()

    def fetches():
        out = torch.ones(8) * 2
        with jitcheck.sanctioned_fetch("fused"):
            return out.cpu().numpy()

    res = guard.run_dispatch(fetches, timeout_s=5.0, device="cpu")
    np.testing.assert_array_equal(res, np.full(8, 2.0))
    st = jitcheck.state()
    assert st["host_sync_count"] == 0
    assert st["sanctioned_fetches"] >= 1
    assert st["sanctioned_by_tag"]["fused"] >= 1


def test_cold_sync_outside_dispatch_is_not_hot():
    jitcheck.enable()
    _ = float(torch.tensor(1.0))       # no dispatch region active
    assert jitcheck.state()["host_sync_count"] == 0


def test_plain_version_body_is_the_devices_work():
    """A kernel's plain version stands in for the kernel on a CPU cell:
    its own conversions are not host syncs of the dispatch."""
    jitcheck.enable()

    @jitcheck.plain_version
    def plain(t):
        return torch.tensor(int(t.sum()))

    guard.run_dispatch(lambda: plain(torch.ones(3)), timeout_s=5.0,
                       device="cpu")
    assert jitcheck.state()["host_sync_count"] == 0


def test_cuda_sync_warning_routed_to_its_thread():
    """The sync debug mode's warning counts on the thread that raised it:
    in its hot region a sync, sanctioned inside sanctioned_fetch; outside
    any region it is dropped."""
    jitcheck.enable()
    msg = UserWarning(jitcheck._SYNC_MSG)

    def raises():
        jitcheck._showwarning(msg, UserWarning, "x.py", 1)
        with jitcheck.sanctioned_fetch("wave"):
            jitcheck._showwarning(msg, UserWarning, "x.py", 2)

    guard.run_dispatch(raises, timeout_s=5.0, device="cpu")
    jitcheck._showwarning(msg, UserWarning, "x.py", 3)   # cold
    st = jitcheck.state()
    assert [r["kind"] for r in st["host_syncs"]] == ["cuda_sync"]
    assert st["sanctioned_by_tag"] == {"wave": 1}
    assert st["cuda_sync_warnings"] == 3


def test_no_sync_call_in_any_cuda_launcher():
    """A kernel launched through ctypes is invisible to torch's sync
    check: the launchers must not synchronize themselves."""
    pat = re.compile(r"cudaDeviceSynchronize|cudaStreamSynchronize|"
                     r"cudaMemcpy\(|cudaEventSynchronize")
    srcs = sorted((ROOT / "nomad_tpu_torch" / "csrc").glob("*.cu*"))
    assert srcs
    hits = [f"{p.name}:{i + 1}" for p in srcs
            for i, line in enumerate(p.read_text().splitlines())
            if pat.search(line)]
    assert hits == [], hits


def test_dense_and_preempt_maxima_come_from_the_host_lanes():
    """The range checks read IndexMax taken from numpy lanes; the checks
    still raise on an out-of-range index."""
    lane = _lane(0)
    const, init, b = (type(t)(*(np.asarray(a)[None] for a in t))
                      for t in (lane.const, lane.init, lane.batch))
    host = dense.index_max(const, init, b)
    tens = dense.index_max(*(type(t)(*(torch.from_numpy(np.asarray(a))
                                       for a in t))
                             for t in (const, init, b)))
    assert host == tens
    assert host.limit == int(np.asarray(b.limit).max())
    dense.check_index_max((("penalty_idx", host.penalty_idx, 1 << 30),))
    with pytest.raises(ValueError, match="spread_vidx holds an index"):
        dense.check_index_max((("spread_vidx", 5, 5),))


# ----------------------------------------------------------------------
# dtype drift


def test_float64_beside_float32_in_a_tree_reported():
    from nomad_tpu_torch.server.telemetry import metrics
    metrics.reset()
    jitcheck.enable()
    resident.device_put_cached([np.ones(4, np.float32),
                                np.ones(4, np.float64)], device="cpu")
    st = jitcheck.state()
    assert st["x64_leak_count"] == 1
    assert st["dtype_drift"][0]["kind"] == "float64"
    assert metrics.snapshot()["counters"].get(
        "nomad.jitcheck.x64_leak", 0) >= 1
    metrics.reset()


def test_float64_tree_alone_is_a_float64_dispatch():
    jitcheck.enable()
    resident.device_put_cached([np.ones(4, np.float64)], device="cpu")
    assert jitcheck.state()["x64_leak_count"] == 0


def test_float64_tensor_in_a_float32_launch_reported():
    jitcheck.enable()
    jitcheck.note_launch("wave_block", torch.float32,
                         [torch.ones(2), torch.ones(2, dtype=torch.float64)],
                         [2, 3])
    jitcheck.note_launch("wave_block", torch.float64,
                         [torch.ones(2, dtype=torch.float64)], [2, 3])
    st = jitcheck.state(sites=True)
    assert st["x64_leak_count"] == 1
    assert st["dtype_drift"][0]["where"] == "launch"
    site = [s for s in st["sites"] if s["site"] == "kernel:wave_block"][0]
    assert site["launches"] == 2 and site["sigs"] == 2


# ----------------------------------------------------------------------
# fingerprint-cache mutation + frozen-memo invariant


def test_fingerprint_mutation_detected():
    from nomad_tpu_torch.server.telemetry import metrics
    metrics.reset()
    jitcheck.enable()
    a = np.arange(16, dtype=np.float32)
    jitcheck.note_fingerprint(a)
    assert jitcheck.verify_caches() == 0
    a[3] = 99.0
    assert jitcheck.verify_caches() == 1
    st = jitcheck.state()
    assert any(m["kind"] == "content-mutation" for m in st["mutations"])
    assert metrics.snapshot()["counters"].get(
        "nomad.jitcheck.mutated_cache", 0) >= 1
    metrics.reset()


def test_resident_sources_register_and_freeze(monkeypatch):
    monkeypatch.setenv("NOMAD_TPU_TORCH_CONST_CACHE_MIN_BYTES", "1")
    jitcheck.enable()
    src = np.arange(64, dtype=np.float32)
    resident.device_put_cached([src], device="cpu")
    assert not src.flags.writeable
    with pytest.raises(ValueError):
        src[0] = 1.0
    # thawed and written behind the cache's back: found
    src.setflags(write=True)
    src[0] = 1.0
    assert jitcheck.verify_caches() >= 1
    assert jitcheck.state()["mutation_count"] >= 1


def test_frozen_memo_mutation_raises_and_is_found():
    """Arrays that entered a pack memo are frozen; thawing one is found."""
    from nomad_tpu_torch import mock as pmock
    jitcheck.enable()
    nodes = []
    for k in range(4):
        n = pmock.node()
        n.id = f"jcf-node-{k:04d}"
        n.compute_class()
        nodes.append(n)
    matrix = tpack.pack_nodes_cached(nodes, 11)
    for arr in (matrix.cpu_cap, matrix.mem_cap, matrix.disk_cap,
                matrix.dyn_free, matrix.valid):
        assert not arr.flags.writeable
    with pytest.raises(ValueError):
        matrix.cpu_cap[0] = 1.0
    assert jitcheck.verify_caches() == 0
    matrix.cpu_cap.setflags(write=True)
    assert jitcheck.verify_caches() == 1
    assert jitcheck.state()["mutations"][0]["kind"] == "thawed-memo"
    loose = tpack.pack_nodes(nodes)
    assert loose.cpu_cap.flags.writeable


def test_arena_pool_buffers_freeze_on_release():
    jitcheck.enable()
    specs = {"t": [((4, 8), np.float32)]}
    ent, _ = batch._ARENA.acquire(("jck", 4, 8), specs)
    arr = ent.trees["t"][0]
    arr[:] = 1.0                      # checked out: writable
    batch._ARENA.release(ent)
    if batch._arena_enabled():
        with pytest.raises(ValueError):
            arr[:] = 2.0              # pooled: frozen
        ent2, reused = batch._ARENA.acquire(("jck", 4, 8), specs)
        assert reused and ent2 is ent
        ent2.trees["t"][0][:] = 3.0   # re-acquired: thawed, not a finding
        assert jitcheck.verify_caches() == 0
        batch._ARENA.release(ent2)
    assert jitcheck.state()["mutation_count"] == 0


# ----------------------------------------------------------------------
# the same verdict as the reference's checker


def _ref_sync():
    import jax.numpy as jnp
    from nomad_tpu.solver import guard as ref_guard
    ref_guard.run_dispatch(lambda: float(jnp.float32(3.0)), timeout_s=5.0)


def _port_sync():
    guard.run_dispatch(lambda: float(torch.tensor(3.0)), timeout_s=5.0,
                       device="cpu")


def _ref_sanctioned():
    import jax
    import jax.numpy as jnp
    from nomad_tpu.solver import guard as ref_guard

    def fn():
        with ref_jitcheck.sanctioned_fetch("fused"):
            return jax.device_get(jnp.ones(4))
    ref_guard.run_dispatch(fn, timeout_s=5.0)


def _port_sanctioned():
    def fn():
        with jitcheck.sanctioned_fetch("fused"):
            return torch.ones(4).cpu().numpy()
    guard.run_dispatch(fn, timeout_s=5.0, device="cpu")


def _cold(mod, make):
    def run():
        float(make())
    return run


def _mutate(mod):
    def run():
        a = np.arange(8, dtype=np.float32)
        mod.note_fingerprint(a)
        a[0] = 5.0
    return run


def _thaw(mod):
    def run():
        a = np.zeros(4)
        a.setflags(write=False)
        mod.note_frozen(a)
        a.setflags(write=True)
    return run


def _ref_x64():
    import jax
    jax.device_put(np.ones(4, dtype=np.float64))


def _port_x64():
    resident.device_put_cached([np.ones(4, np.float32),
                                np.ones(4, np.float64)], device="cpu")


def _verdict(st):
    return (st["host_sync_count"] > 0, st["mutation_count"] > 0,
            st["x64_leak_count"] > 0, st["sanctioned_fetches"] > 0)


SCENARIOS = {
    "hot-sync": (_ref_sync, _port_sync),
    "sanctioned": (_ref_sanctioned, _port_sanctioned),
    "cold-sync": (lambda: float(__import__("jax").numpy.float32(1.0)),
                  lambda: float(torch.tensor(1.0))),
    "mutation": (_mutate(ref_jitcheck), _mutate(jitcheck)),
    "thaw": (_thaw(ref_jitcheck), _thaw(jitcheck)),
    "float64": (_ref_x64, _port_x64),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_same_verdict_as_the_reference(name, monkeypatch):
    """Each mirrored scenario under the reference's jitcheck, then under
    the port's: the same classes found (or none)."""
    monkeypatch.setenv("NOMAD_TPU_JITCHECK_X64", "1")
    ref_fn, port_fn = SCENARIOS[name]
    ref_jitcheck.enable()
    try:
        ref_fn()
        ref = _verdict(ref_jitcheck.state())
    finally:
        ref_jitcheck.disable()
        ref_jitcheck._reset_for_tests()
    jitcheck.enable()
    port_fn()
    assert _verdict(jitcheck.state()) == ref
