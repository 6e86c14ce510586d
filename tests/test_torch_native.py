"""The native control plane's C library (nomad_tpu_torch/native.py,
csrc/pack_kernels.cc) held against its numpy forms and the JAX package's
nomad_tpu.native, bit for bit, on inputs made from a seed: the cases of
tests/test_native.py (less its wall-time ratio test), and the build
itself -- where it goes, concurrent first uses, a failed build, the
interpreter lock released during a call.

The reference's library is the reference's own source, built here by
native.build where the checkout has none, and loaded through its
NOMAD_TPU_NATIVE_LIB."""
import os
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from nomad_tpu import native as ref_native
from nomad_tpu_torch import native
from nomad_tpu_torch.scheduler import util as port_util

ROOT = Path(__file__).resolve().parents[1]
REF_SOURCE = ROOT / "native" / "pack_kernels.cc"
# the reference's library when the checkout has none: outside the port's
# own build root
REF_BUILD_ROOT = ROOT / "build" / "reference_native"

# every exported nt_* of the port's source and the test holding it
KERNEL_PARITY_TESTS = {
    "nt_pack_usage": "test_pack_usage_bits",
    "nt_count_placed": "test_count_placed_bits",
    "nt_static_ports_free": "test_static_ports_free_bits",
    "nt_verify_fit": "test_verify_fit_bits",
    "nt_shuffled_order": "test_shuffled_order_bits",
    "nt_solve_eval": "test_solve_eval_bits",
    "nt_verify_plan": "test_verify_plan_bits",
    "nt_abi_version": "test_library_builds_loads_and_checks_its_abi",
}


def ensure_reference_native():
    """Load the reference's C library (its source built by
    native.build if the checkout has none) so the reference runs its
    native paths, as it does by default where the library exists."""
    if ref_native.available():
        return
    info = native.build(REF_SOURCE, REF_BUILD_ROOT)
    os.environ["NOMAD_TPU_NATIVE_LIB"] = info["path"]
    ref_native._load_attempted = False
    ref_native._lib = None
    assert ref_native.available(), info


@pytest.fixture(scope="module", autouse=True)
def _reference_library():
    ensure_reference_native()


def ref_plain(fn, *args, **kwargs):
    """The reference's function with its library hidden: its numpy
    fallback."""
    lib, ref_native._lib = ref_native._lib, None
    try:
        return fn(*args, **kwargs)
    finally:
        ref_native._lib = lib


def assert_bits(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


def _rows(n_rows, n_pad, rng):
    """(reference test_native.py:59) A table with dead rows, rows of no
    node, ports on every third row and dynamic ports on every sixth."""
    node_slot = rng.integers(-1, n_pad, n_rows).astype(np.int32)
    cpu = rng.uniform(100, 2000, n_rows)
    mem = rng.uniform(64, 4096, n_rows)
    disk = rng.uniform(0, 500, n_rows)
    live = rng.integers(0, 2, n_rows).astype(np.uint8)
    ports = np.full((n_rows, native.MAX_PORTS_PER_ALLOC), -1,
                    dtype=np.int32)
    for i in range(0, n_rows, 3):
        ports[i, 0] = int(rng.integers(1024, 65536))
        if i % 6 == 0:
            ports[i, 1] = int(rng.integers(20000, 32001))
    dyn_lo = np.full(n_pad, 20000, dtype=np.int32)
    dyn_hi = np.full(n_pad, 32000, dtype=np.int32)
    return node_slot, cpu, mem, disk, live, ports, dyn_lo, dyn_hi


def test_library_builds_loads_and_checks_its_abi():
    lib = native.load()
    assert lib.nt_abi_version() == native.ABI_VERSION \
        == ref_native.ABI_VERSION == ref_native._lib.nt_abi_version()
    path = native.library_path()
    assert path.exists() and path.is_relative_to(ROOT / "build"
                                                 / "nomad_tpu_torch")
    assert "build/" in (ROOT / ".gitignore").read_text().split()
    assert native.SOURCE == ROOT / "nomad_tpu_torch" / "csrc" \
        / "pack_kernels.cc"
    assert "-march=native" in native.CXX_FLAGS
    assert "-ffp-contract=off" in native.CXX_FLAGS


@pytest.mark.parametrize("seed,n_rows,n_pad,ports,seeded", [
    (42, 500, 64, True, False), (43, 500, 64, False, False),
    (44, 300, 32, True, True), (45, 0, 16, True, True),
    (46, 2000, 7, False, False)])
def test_pack_usage_bits(seed, n_rows, n_pad, ports, seeded):
    rng = np.random.default_rng(seed)
    node_slot, cpu, mem, disk, live, port_cols, lo, hi = _rows(
        n_rows, n_pad, rng)
    if not ports:
        port_cols = None
    words = None
    if seeded:
        words = np.zeros((n_pad, native.PORT_WORDS), dtype=np.uint32)
        words[:, 1000 >> 5] |= np.uint32(1 << (1000 & 31))
    args = (node_slot, cpu, mem, disk, live, port_cols, lo, hi, n_pad)
    got = native.pack_usage_native(*args, port_words_seed=words)
    assert_bits(got, native.pack_usage_plain(*args, port_words_seed=words))
    assert_bits(got, ref_native.pack_usage(*args, port_words_seed=words))
    assert_bits(got, ref_plain(ref_native.pack_usage, *args,
                               port_words_seed=words))


@pytest.mark.parametrize("seed", [7, 8, 9])
def test_count_placed_bits(seed):
    rng = np.random.default_rng(seed)
    n_rows, n_pad = 300, 32
    node_slot = rng.integers(-1, n_pad, n_rows).astype(np.int32)
    live = rng.integers(0, 2, n_rows).astype(np.uint8)
    job_hash = rng.integers(0, 4, n_rows).astype(np.uint64)
    jobtg_hash = rng.integers(0, 8, n_rows).astype(np.uint64)
    args = (node_slot, job_hash, jobtg_hash, live, 2, 5, n_pad)
    got = native.count_placed_native(*args)
    assert_bits(got, native.count_placed_plain(*args))
    assert_bits(got, ref_native.count_placed(*args))
    assert_bits(got, ref_plain(ref_native.count_placed, *args))


@pytest.mark.parametrize("seed,n_check", [(3, 5), (4, 0), (5, 40)])
def test_static_ports_free_bits(seed, n_check):
    rng = np.random.default_rng(seed)
    n_pad = 16
    words = np.zeros((n_pad, native.PORT_WORDS), dtype=np.uint32)
    for slot in range(n_pad):
        for p in rng.integers(0, 65536, 20):
            words[slot, p >> 5] |= np.uint32(1 << (p & 31))
    check = rng.integers(-5, 70000, n_check).astype(np.int32)
    if n_check:
        # a taken port on half the nodes
        check[0] = 4242
        words[::2, 4242 >> 5] |= np.uint32(1 << (4242 & 31))
    got = native.static_ports_free_native(words, check)
    assert got.dtype == bool
    assert_bits([got], [native.static_ports_free_plain(words, check)])
    assert_bits([got], [ref_native.static_ports_free(words, check)])
    assert_bits([got], [ref_plain(ref_native.static_ports_free, words,
                                  check)])


@pytest.mark.parametrize("seed", [11, 12])
def test_verify_fit_bits(seed):
    rng = np.random.default_rng(seed)
    n = 200
    caps = [rng.uniform(1000, 8000, n) for _ in range(3)]
    used = [rng.uniform(0, 8000, n) for _ in range(3)]
    asks = [rng.uniform(0, 2000, n) for _ in range(3)]
    got = native.verify_fit_native(*caps, *used, *asks)
    assert set(np.unique(got)) == {0, 1, 2, 3}
    assert_bits([got], [native.verify_fit_plain(*caps, *used, *asks)])
    assert_bits([got], [ref_native.verify_fit(*caps, *used, *asks)])
    assert_bits([got], [ref_plain(ref_native.verify_fit, *caps, *used,
                                  *asks)])


def _verify_plan_case(rng, n_rows=400, n=48, n_delta=600, n_ask=200):
    """(reference test_native.py:210) Signed row-backed deltas over a
    table with dead rows, and direct entries split between the used and
    ask accumulators, with caps tight enough that every dimension
    fails somewhere."""
    tbl = [rng.uniform(100, 2000, n_rows), rng.uniform(64, 4096, n_rows),
           rng.uniform(0, 500, n_rows)]
    live_strict = rng.integers(0, 2, n_rows).astype(np.uint8)
    d_row = rng.integers(0, n_rows, n_delta).astype(np.int64)
    d_pos = rng.integers(0, n, n_delta).astype(np.int32)
    d_sign = rng.choice(np.array([-1, 1], dtype=np.int8), n_delta)
    a_pos = rng.integers(0, n, n_ask).astype(np.int32)
    a_vals = [rng.uniform(0, 1500, n_ask), rng.uniform(0, 2048, n_ask),
              rng.uniform(0, 300, n_ask)]
    a_into_used = rng.integers(0, 2, n_ask).astype(np.int8)
    caps = [rng.uniform(2000, 9000, n) for _ in range(3)]
    used = [np.ascontiguousarray(rng.uniform(0, 6000, n))
            for _ in range(3)]
    return ((*tbl, live_strict, d_row, d_pos, d_sign, a_pos, *a_vals,
             a_into_used, *caps), used)


@pytest.mark.parametrize("seed", [0, 1, 2, 17, 99])
def test_verify_plan_bits(seed):
    """The failing dimensions AND the mutated used accumulators, bit for
    bit: every form applies the entries strictly in order."""
    head, used = _verify_plan_case(np.random.default_rng(seed))
    outs = []
    for fn in (native.verify_plan_native, native.verify_plan_plain,
               ref_native.verify_plan,
               lambda *a: ref_plain(ref_native.verify_plan, *a)):
        u = [x.copy() for x in used]
        outs.append([fn(*head, *u), *u])
    assert len(set(np.unique(outs[0][0]))) >= 3
    for other in outs[1:]:
        assert_bits(outs[0], other)


def test_verify_plan_empty_inputs():
    n = 8
    z = np.zeros(0)
    args = (z, z, z, np.zeros(0, dtype=np.uint8),
            np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int32),
            np.zeros(0, dtype=np.int8), np.zeros(0, dtype=np.int32), z, z,
            z, np.zeros(0, dtype=np.int8), np.full(n, 100.0),
            np.full(n, 100.0), np.full(n, 100.0))
    for fn in (native.verify_plan_native, native.verify_plan_plain):
        dims = fn(*args, np.zeros(n), np.zeros(n), np.zeros(n))
        assert_bits([dims], [np.zeros(n, dtype=np.int32)])


@pytest.mark.parametrize("eval_id,idx,n", [
    ("native-parity-eval-0001", 7, 1), ("native-parity-eval-0001", 7, 97),
    ("another-eval-fffe", 123, 1000)])
def test_shuffled_order_bits(eval_id, idx, n):
    seed = port_util.shuffle_seed(eval_id, idx)
    got = native.shuffled_order_native(seed, n)
    assert list(got) == port_util.shuffled_order(eval_id, idx, n)
    assert_bits([got], [ref_native.shuffled_order(seed, n)])


@pytest.mark.parametrize("seed,spread", [(21, False), (22, True),
                                         (23, False)])
def test_solve_eval_bits(seed, spread):
    """The compiled oracle's choices and carried usage, against the
    reference's library on the same packed world (the host stack's
    decisions: tests/test_torch_native_oracle.py)."""
    rng = np.random.default_rng(seed)
    n = 300
    caps = [rng.choice([2000.0, 4000.0, 8000.0], n),
            rng.choice([4096.0, 8192.0, 16384.0], n), np.full(n, 100e3)]
    used = [rng.uniform(0, 1500, n), rng.uniform(0, 3000, n),
            rng.uniform(0, 1000, n)]
    placed = rng.integers(0, 3, n).astype(np.int32)
    eligible = (rng.random(n) < 0.9).astype(np.uint8)
    outs = []
    for fn in (native.solve_eval_native, ref_native.solve_eval):
        u = [x.copy() for x in used]
        p = placed.copy()
        choice = fn(*caps, *u, p, eligible, 0x1234_5678_9ABC + seed,
                    500.0, 256.0, 150.0, 40, 9, 120, spread_alg=spread)
        outs.append([choice, *u, p])
    assert (outs[0][0] >= 0).sum() > 60
    assert_bits(outs[0], outs[1])


def _long_solve_args(n=10_000, placements=200):
    """A solve_eval whose every placement scores every node (limit n):
    about n x placements scored nodes, long enough to watch."""
    rng = np.random.default_rng(77)
    caps = [np.full(n, 64_000.0), np.full(n, 262_144.0), np.full(n, 1e6)]
    used = [rng.uniform(0, 1000, n) for _ in range(3)]
    return (*caps, *used, np.zeros(n, dtype=np.int32),
            np.ones(n, dtype=np.uint8), 99, 100.0, 64.0, 10.0, 10, n,
            placements)


def test_a_call_releases_the_interpreter_lock():
    """(reference test_native.py:279) While one thread is inside a C
    call, this thread keeps running Python: its longest pause during
    the call stays well under the call's length (a call holding the
    lock would pause it for the whole call)."""
    args = _long_solve_args()
    native.load()
    span = {}

    def call():
        span["t0"] = time.perf_counter()
        native.solve_eval_native(*args)
        span["t1"] = time.perf_counter()

    t = threading.Thread(target=call, daemon=True)
    longest = 0.0
    last = time.perf_counter()
    t.start()           # the call may run before start() returns here
    while True:
        now = time.perf_counter()
        longest = max(longest, now - last)
        last = now
        if not t.is_alive():
            break
    t.join(timeout=60)
    assert not t.is_alive(), "the solve_eval call did not end in 60 s"
    length = span["t1"] - span["t0"]
    assert length > 0.05, f"the call took {length * 1e3:.1f} ms: too short"
    assert longest < length / 2, (
        f"this thread paused {longest * 1e3:.1f} ms during a "
        f"{length * 1e3:.1f} ms call: the call holds the lock")


def test_every_exported_entry_point_has_a_parity_test():
    src = native.SOURCE.read_text()
    exported = set(re.findall(
        r"^(?:void|int32_t|int64_t|double)\s+(nt_\w+)\s*\(", src,
        re.MULTILINE))
    ref = set(re.findall(
        r"^(?:void|int32_t|int64_t|double)\s+(nt_\w+)\s*\(",
        REF_SOURCE.read_text(), re.MULTILINE))
    assert exported == ref == set(KERNEL_PARITY_TESTS)
    body = Path(__file__).read_text()
    for sym, test in KERNEL_PARITY_TESTS.items():
        assert f"def {test}(" in body, sym
    lib = native.load()
    for sym in exported:
        assert hasattr(lib, sym), sym


def test_concurrent_first_uses_build_once(tmp_path):
    """Three processes load a library that is not built yet, at once:
    one compiles, every one loads the same whole file."""
    code = (
        "import sys, ctypes\n"
        "from pathlib import Path\n"
        "from nomad_tpu_torch import native\n"
        "info = native.build(native.SOURCE, Path(sys.argv[1]))\n"
        "lib = native.bind(ctypes.CDLL(info['path']))\n"
        "print(info['built'], info['path'])\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, err
            outs.append(out.split())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert sorted(o[0] for o in outs) == ["False"] * 2 + ["True"]
    assert len({o[1] for o in outs}) == 1
    built = list(tmp_path.rglob("*.so"))
    assert [p.name for p in built] == ["pack_kernels.so"]


def test_failed_build_raises_and_nothing_falls_back(tmp_path, monkeypatch):
    """A compiler that fails: load() raises with its output, and with the
    switch on the folds raise too (no numpy fallback); with the switch
    off they run their numpy forms."""
    cxx = tmp_path / "cxx"
    cxx.write_text("#!/bin/sh\necho 'no compiler here' >&2\nexit 3\n")
    cxx.chmod(0o755)
    monkeypatch.setenv("CXX", str(cxx))
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", None)
    with pytest.raises(RuntimeError, match="no compiler here"):
        native.load()
    rng = np.random.default_rng(5)
    args = _rows(50, 8, rng) + (8,)
    monkeypatch.delenv("NOMAD_TPU_TORCH_NATIVE_CP", raising=False)
    with pytest.raises(RuntimeError, match="no compiler here"):
        native.pack_usage(*args)
    monkeypatch.setenv("NOMAD_TPU_TORCH_NATIVE_CP", "0")
    assert_bits(native.pack_usage(*args), native.pack_usage_plain(*args))


def test_library_key_follows_source_compiler_and_flags(tmp_path,
                                                       monkeypatch):
    a = native.library_path()
    src = tmp_path / "pack_kernels.cc"
    src.write_text(native.SOURCE.read_text() + "\n// edited\n")
    assert native.library_path(src).parent.name != a.parent.name
    monkeypatch.setenv("CXX", "c++")
    assert native.library_path().parent.name != a.parent.name
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-g",))
    monkeypatch.delenv("CXX")
    assert native.library_path().parent.name != a.parent.name


def test_switch_is_read_at_each_use(monkeypatch):
    monkeypatch.delenv("NOMAD_TPU_TORCH_NATIVE_CP", raising=False)
    assert native.native_cp_enabled()
    monkeypatch.setenv("NOMAD_TPU_TORCH_NATIVE_CP", "0")
    assert not native.native_cp_enabled()
    monkeypatch.setenv("NOMAD_TPU_TORCH_NATIVE_CP", "1")
    assert native.native_cp_enabled()



def _bad_input(case):
    rng = np.random.default_rng(31)
    if case.startswith("verify_plan"):
        head, used = _verify_plan_case(rng, n_rows=40, n=8, n_delta=20,
                                       n_ask=10)
        head = list(head)
        if case == "verify_plan_row":
            head[4] = head[4].copy()
            head[4][3] = 40                 # past the table's rows
        elif case == "verify_plan_pos":
            head[7] = head[7].copy()
            head[7][0] = 8                  # past the nodes
        else:
            head[12] = head[12][:5]         # a short cap column
        return native.verify_plan_native, (*head, *used), {}
    args = list(_rows(30, 8, rng)) + [8]
    if case == "pack_usage_seed":
        return native.pack_usage_native, args, {
            "port_words_seed": np.zeros((4, native.PORT_WORDS), np.uint32)}
    args[5] = args[5][:, :3]                # ports of the wrong width
    return native.pack_usage_native, args, {}


@pytest.mark.parametrize("case", ["verify_plan_row", "verify_plan_pos",
                                  "verify_plan_caps", "pack_usage_seed",
                                  "pack_usage_ports"])
def test_bad_shapes_raise_before_the_c_call(case):
    """The C loops index without bounds: shapes and positions they would
    read past are refused in Python."""
    fn, args, kw = _bad_input(case)
    with pytest.raises(ValueError, match="native control plane"):
        fn(*args, **kw)


@pytest.mark.parametrize("switch", ["1", "0"])
def test_alloc_table_pack_equals_direct_pack(switch, monkeypatch):
    """(reference test_native.py:146) The alloc table's fold (C, or numpy
    with the switch off) equals the direct fold of each node's live
    allocs, ports and dynamic-port counts included."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.state.store import StateStore
    from nomad_tpu_torch.structs import NetworkResource, Port
    from nomad_tpu_torch.tensor.pack import pack_nodes, pack_usage

    monkeypatch.setenv("NOMAD_TPU_TORCH_NATIVE_CP", switch)
    s = StateStore()
    nodes = [mock.node() for _ in range(6)]
    for n in nodes:
        s.upsert_node(n)
    jobs = [mock.job() for _ in range(3)]
    for j in jobs:
        s.upsert_job(j)
    rng = np.random.default_rng(5)
    for j in jobs:
        for i in range(4):
            a = mock.alloc_for(j, nodes[int(rng.integers(0, 6))], i)
            a.client_status = "running" if rng.random() < 0.8 else "complete"
            if i % 2:
                a.allocated_resources.shared.networks = [NetworkResource(
                    reserved_ports=[Port(label="http",
                                         value=int(rng.integers(20000,
                                                                32000)))])]
            s.upsert_allocs([a])

    matrix = pack_nodes(nodes)
    job = jobs[0]
    tg = job.task_groups[0]
    by_node = {n.id: [a for a in s.allocs_by_node(n.id)
                      if not a.client_terminal_status()] for n in nodes}
    want = pack_usage(matrix, by_node, job.id, tg.name, job.namespace, nodes)

    slots = np.full(matrix.n_pad, -1, dtype=np.int32)
    for i, n in enumerate(nodes):
        slots[i] = s.alloc_table.node_slot_of(n.id)
    packed = s.alloc_table.pack(matrix.n_pad, slots, with_ports=True,
                                port_words_seed=matrix.port_bitmap)
    placed, placed_job = s.alloc_table.count_placed(
        matrix.n_pad, packed["row_slots"], job.namespace, job.id, tg.name)
    assert_bits([packed["used_cpu"], packed["used_mem"], packed["used_disk"],
                 packed["dyn_used"], placed, placed_job,
                 packed["port_words"]],
                [want.used_cpu, want.used_mem, want.used_disk, want.dyn_used,
                 want.placed_jobtg, want.placed_job, want.port_bitmap])
    assert packed["dyn_used"].any()
