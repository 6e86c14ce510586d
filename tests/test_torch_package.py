"""Package boundaries of the port: it stands alone (no jax, nothing of
nomad_tpu), runs on the card unless told otherwise, and never falls back
silently."""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from nomad_tpu_torch import kernels
from nomad_tpu_torch.solver.batch import fuse_and_solve
from nomad_tpu_torch.solver.service import evictions, pack_lane_arrays
from nomad_tpu_torch.tensor.pack import NodeMatrix, PreemptInfo, UsageState

# One intra-op thread: the port's CPU tensors are small, and the test
# run already keeps one xdist worker busy per core.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "nomad_tpu_torch"


def test_import_loads_no_jax_and_nothing_of_the_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import nomad_tpu_torch\n"
        "for m in pkgutil.walk_packages(nomad_tpu_torch.__path__,"
        " 'nomad_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'nomad_tpu'))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_preempt_module_loads_no_jax_and_nothing_of_the_reference():
    code = (
        "import sys\n"
        "import nomad_tpu_torch.solver.preempt\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'nomad_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_lpq_module_loads_no_jax_and_nothing_of_the_reference():
    code = (
        "import sys\n"
        "import nomad_tpu_torch.solver.lpq\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'nomad_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("module", ["nomad_tpu_torch.solver.resident",
                                    "nomad_tpu_torch.state.store"])
def test_residency_modules_load_no_jax_and_nothing_of_the_reference(
        module):
    code = (
        "import sys\n"
        f"import {module}\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'nomad_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("module", ["nomad_tpu_torch.faultinject",
                                    "nomad_tpu_torch.solver.guard",
                                    "nomad_tpu_torch.solver.batch"])
def test_dispatch_layer_modules_load_no_jax_and_nothing_of_the_reference(
        module):
    code = (
        "import sys\n"
        f"import {module}\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'nomad_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("module", ["nomad_tpu_torch.api",
                                    "nomad_tpu_torch.api.client",
                                    "nomad_tpu_torch.api.config",
                                    "nomad_tpu_torch.api.devagent",
                                    "nomad_tpu_torch.api.http",
                                    "nomad_tpu_torch.cli",
                                    "nomad_tpu_torch.client",
                                    "nomad_tpu_torch.client.agent",
                                    "nomad_tpu_torch.client.fingerprint",
                                    "nomad_tpu_torch.client.numalib",
                                    "nomad_tpu_torch.jobspec",
                                    "nomad_tpu_torch.tlsutil",
                                    "nomad_tpu_torch.structs.codec"])
def test_agent_modules_load_no_jax_and_nothing_of_the_reference(module):
    """The agent's entry points (the API, the CLI, the jobspec, the node
    side) stand alone too, and none of them starts CUDA at import."""
    code = (
        "import sys\n"
        "import torch\n"
        "torch.cuda.init = lambda: sys.exit('CUDA initialized')\n"
        f"import {module}\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'nomad_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad or torch.cuda.is_initialized() else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("module", ["nomad_tpu_torch.structs",
                                    "nomad_tpu_torch.mock",
                                    "nomad_tpu_torch.carry",
                                    "nomad_tpu_torch.scheduler.context",
                                    "nomad_tpu_torch.scheduler.feasible",
                                    "nomad_tpu_torch.scheduler.preemption",
                                    "nomad_tpu_torch.scheduler.rank",
                                    "nomad_tpu_torch.tensor.pack",
                                    "nomad_tpu_torch.solver.service"])
def test_struct_modules_load_no_jax_and_nothing_of_the_reference(module):
    code = (
        "import sys\n"
        f"import {module}\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'nomad_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_placement_service_defaults_to_cuda():
    """TpuPlacementService resolves its device when built: with no card
    the default (cuda) raises, and nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.scheduler.context import EvalContext
    from nomad_tpu_torch.solver.service import TpuPlacementService
    from nomad_tpu_torch.state.store import StateStore
    from nomad_tpu_torch.structs import Plan
    job = mock.job()
    ctx = EvalContext(StateStore().snapshot(), Plan(job=job))
    with pytest.raises(RuntimeError, match="CUDA"):
        TpuPlacementService(ctx, job, False, False)
    assert TpuPlacementService(ctx, job, False, False,
                               device="cpu").dtype == "float64"


def test_every_port_env_knob_is_documented():
    """Each NOMAD_TPU_TORCH_* variable the port reads is named in the
    README's port section."""
    import re
    readme = (ROOT / "README.md").read_text()
    knobs = set()
    for path in list(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        knobs |= set(re.findall(r"NOMAD_TPU_TORCH_[A-Z0-9_]+",
                                path.read_text()))
    assert {"NOMAD_TPU_TORCH_LPQ_STEPS", "NOMAD_TPU_TORCH_LPQ_COMPARE",
            "NOMAD_TPU_TORCH_BATCH_FIXPOINT", "NOMAD_TPU_TORCH_CONST_CACHE",
            "NOMAD_TPU_TORCH_CONST_CACHE_ENTRIES",
            "NOMAD_TPU_TORCH_CONST_CACHE_MB",
            "NOMAD_TPU_TORCH_CONST_CACHE_MIN_BYTES",
            "NOMAD_TPU_TORCH_DELTA_STREAM", "NOMAD_TPU_TORCH_DELTA_CHAIN_MB",
            "NOMAD_TPU_TORCH_DELTA_MAX_FRAC",
            "NOMAD_TPU_TORCH_DELTA_JOURNAL",
            "NOMAD_TPU_TORCH_DISPATCH_DEPTH",
            "NOMAD_TPU_TORCH_DISPATCH_TIMEOUT",
            "NOMAD_TPU_TORCH_BREAKER_THRESHOLD",
            "NOMAD_TPU_TORCH_BREAKER_BACKOFF",
            "NOMAD_TPU_TORCH_BREAKER_BACKOFF_MAX",
            "NOMAD_TPU_TORCH_BREAKER_PROBE_TIMEOUT",
            "NOMAD_TPU_TORCH_REPROBE_TIMEOUT",
            "NOMAD_TPU_TORCH_BACKEND_TIMEOUT",
            "NOMAD_TPU_TORCH_FAULT_INJECT", "NOMAD_TPU_TORCH_TRACE",
            "NOMAD_TPU_TORCH_TRACE_SAMPLE", "NOMAD_TPU_TORCH_TRACE_SLOW_MS",
            "NOMAD_TPU_TORCH_TRACE_CAP", "NOMAD_TPU_TORCH_TRACE_MB",
            "NOMAD_TPU_TORCH_TRACE_MAX_SPANS", "NOMAD_TPU_TORCH_XFEROBS",
            "NOMAD_TPU_TORCH_XFEROBS_RING", "NOMAD_TPU_TORCH_QUALITY",
            "NOMAD_TPU_TORCH_QUALITY_AUDIT_SAMPLE",
            "NOMAD_TPU_TORCH_QUALITY_AUDIT_PLACES",
            "NOMAD_TPU_TORCH_QUALITY_DRIFT_TOL",
            "NOMAD_TPU_TORCH_QUALITY_ALERT_AFTER",
            "NOMAD_TPU_TORCH_PACK_CACHE", "NOMAD_TPU_TORCH_PACK_DELTA",
            "NOMAD_TPU_TORCH_FLAP", "NOMAD_TPU_TORCH_FLAP_THRESHOLD",
            "NOMAD_TPU_TORCH_FLAP_WINDOW", "NOMAD_TPU_TORCH_FLAP_BASE_S",
            "NOMAD_TPU_TORCH_FLAP_MAX_S",
            "NOMAD_TPU_TORCH_WORKER_SUPERVISE",
            "NOMAD_TPU_TORCH_WORKER_STALL_S",
            "NOMAD_TPU_TORCH_WORKER_CHECK_S",
            "NOMAD_TPU_TORCH_WORKER_RESTART_BASE_S",
            "NOMAD_TPU_TORCH_WORKER_RESTART_MAX_S",
            "NOMAD_TPU_TORCH_GC_ALLOC_WATERMARK"} <= knobs
    missing = sorted(k for k in knobs if k not in readme)
    assert not missing, missing


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(ROOT) for p in PORT.rglob("*.py")]
    + [Path("chip_smoke.py")]), ids=str)
def test_no_file_of_the_port_imports_jax_or_the_reference(path):
    roots = set(_imported_roots(ROOT / path))
    assert not roots & {"jax", "jaxlib", "nomad_tpu"}, roots


def _tiny_matrix(n=5, n_pad=64):
    return NodeMatrix(
        n_real=n, n_pad=n_pad, node_ids=[f"n{i}" for i in range(n)],
        cpu_cap=np.r_[np.full(n, 4000.0), np.zeros(n_pad - n)],
        mem_cap=np.r_[np.full(n, 8192.0), np.zeros(n_pad - n)],
        disk_cap=np.r_[np.full(n, 102400.0), np.zeros(n_pad - n)],
        dyn_free=np.full(n_pad, 100, dtype=np.int32),
        valid=np.arange(n_pad) < n)


def _tiny_lane(device, count=6, **kw):
    n_pad = 64
    matrix = _tiny_matrix()
    z = np.zeros(n_pad)
    usage = UsageState(z, z, z, z.astype(np.int32), z.astype(np.int32),
                       z.astype(np.int32))
    return pack_lane_arrays(matrix, usage, np.ones(n_pad, dtype=bool),
                            ask=(500.0, 256.0, 150.0), count=count,
                            n_places=count,
                            eval_id="tiny", state_index=1, device=device,
                            **kw)


def test_default_device_is_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    lane = _tiny_lane("cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        fuse_and_solve([lane])
    with pytest.raises(RuntimeError, match="CUDA"):
        _tiny_lane(None)
    # the same lane solves when the caller asks for the CPU
    chosen, _, _ = fuse_and_solve([lane], device="cpu")[0]
    assert (chosen >= 0).all()


def test_dtype_follows_device_unless_named():
    assert _tiny_lane("cpu").dtype_name == "float64"
    assert _tiny_lane("cpu", dtype_name="float32").dtype_name == "float32"
    with pytest.raises(ValueError):
        _tiny_lane("cpu", dtype_name="float16")


def test_non_wave_groups_take_dense_and_preempt_solves():
    """Lanes the wave gate refuses solve through the dense scan, and a
    lane with preemption tables solves through a preemption kernel."""
    lane = _tiny_lane("cpu")
    mixed = lane.batch._replace(
        ask_cpu=np.array([500.0, 500.0, 700.0, 500.0, 500.0, 500.0]))
    lane.batch, lane._wave = mixed, None
    assert not lane.wavefront_ok()
    chosen, _, _ = fuse_and_solve([lane], device="cpu")[0]
    assert (chosen >= 0).all()
    # an affinity lane's window is max(count, 100): 200 is wider than any
    # slot buffer
    wide = _tiny_lane("cpu", count=200,
                      affinity=np.zeros(lane.const.cpu_cap.shape[0]))
    assert int(wide.batch.limit[0]) == 200 and not wide.wavefront_ok()
    chosen, _, _ = fuse_and_solve([wide], device="cpu")[0]
    assert int((chosen >= 0).sum()) == 5 * 8     # 8 asks fill a 4000 MHz node
    # every node holds one 3,800-MHz alloc of a priority-20 job: the
    # priority-70 lane places only by evicting it
    n_pad = lane.const.cpu_cap.shape[0]
    A = 8
    col0 = (np.arange(A) == 0)[None, :] & (np.arange(n_pad) < 5)[:, None]
    info = PreemptInfo(
        cpu=np.where(col0, 3800.0, 0.0), mem=np.where(col0, 512.0, 0.0),
        disk=np.where(col0, 150.0, 0.0),
        prio=np.where(col0, 20, 0).astype(np.int32),
        maxp=np.zeros((n_pad, A), dtype=np.int32),
        grp=np.where(col0, np.arange(n_pad)[:, None], -1).astype(np.int32),
        valid=col0, job_prio=70, counts=np.zeros(64, dtype=np.int32))
    full = UsageState(*(np.r_[np.full(5, v), np.zeros(n_pad - 5)]
                        for v in (3800.0, 512.0, 150.0)),
                      *(np.zeros(n_pad, dtype=np.int32),) * 3)
    pre = pack_lane_arrays(
        _tiny_matrix(), full,
        np.ones(n_pad, dtype=bool), ask=(500.0, 256.0, 150.0), count=5,
        n_places=5, eval_id="tiny", state_index=1, preemption=info,
        device="cpu")
    assert pre.ptab is not None and pre.wavefront_ok()
    chosen, _, _, rows = fuse_and_solve([pre], device="cpu")[0]
    assert (chosen >= 0).all() and rows[0].any()
    # each eviction is the node's one candidate, and no node loses it twice
    hit = [n for n, cols in evictions(pre, chosen, rows) if cols.size]
    assert all(cols.tolist() == [0]
               for _, cols in evictions(pre, chosen, rows) if cols.size)
    assert len(hit) == len(set(hit)) >= 1


def test_every_kernel_is_registered_with_its_source_and_reference():
    """The twelve ported kernels, each built from a csrc/ source that
    names the TPU program it replaces and exports its entry points (the
    mesh programs' coordinate scatter and lane-sharded LP live beside
    their one-card versions). The LP relaxation is float32 only, as the
    reference's LP is on every backend; the two scatters move raw bits,
    one entry point per element size for every dtype of that size; the
    others take both float dtypes."""
    names = {k.name: k for k in kernels.KERNELS}
    assert set(names) == {"wave_block", "wave_compact", "dense_scan",
                          "system_fit", "wave_preempt", "dense_preempt",
                          "lp_relax", "delta_scatter", "wavefront",
                          "dense_shard", "coord_scatter", "lp_shard"}
    for k in kernels.KERNELS:
        src = (kernels.CSRC / k.source).read_text()
        func = k.replaces.split()[-1]
        assert func in src, (k.name, func)
        if k in (kernels.DELTA_SCATTER, kernels.COORD_SCATTER):
            prefix = ("nt_delta_scatter" if k is kernels.DELTA_SCATTER
                      else "nt_coord_scatter")
            for dt, sym in k.symbols.items():
                size = torch.empty(0, dtype=dt).element_size()
                assert sym == f"{prefix}_{size}", (dt, sym)
            assert {torch.bool, torch.int32, torch.float32, torch.int64,
                    torch.float64} <= set(k.symbols)
        else:
            want = ({torch.float32} if k in (kernels.LP_RELAX,
                                             kernels.LP_SHARD)
                    else {torch.float32, torch.float64})
            assert set(k.symbols) == want
        for sym in k.symbols.values():
            assert f'extern "C" int {sym}(' in src, sym
    assert names["dense_scan"].replaces.startswith(
        "nomad_tpu/solver/binpack.py:652 ")
    assert names["system_fit"].replaces.startswith(
        "nomad_tpu/solver/binpack.py:1341 ")
    assert kernels.LP_RELAX.replaces == (
        "nomad_tpu/solver/lpq.py:215 _lp_solve_body")
    assert kernels.DENSE_SHARD.replaces == (
        "nomad_tpu/parallel/mesh.py:251 mesh_solve_fn")
    with pytest.raises(TypeError, match="no kernel"):
        kernels.LP_RELAX.launch(torch.float64, [torch.zeros(1)], [])


def test_slice2_entry_points_default_to_cuda():
    """The dense and system entry points run on the card unless told
    otherwise, and raise without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    from nomad_tpu_torch.solver import dense, system
    from nomad_tpu_torch.solver.service import solve_system_arrays
    lane = _tiny_lane("cpu")
    n_pad = lane.const.cpu_cap.shape[0]
    matrix = NodeMatrix(
        n_real=5, n_pad=n_pad, node_ids=[f"n{i}" for i in range(5)],
        cpu_cap=np.full(n_pad, 4000.0), mem_cap=np.full(n_pad, 8192.0),
        disk_cap=np.full(n_pad, 102400.0),
        dyn_free=np.full(n_pad, 100, dtype=np.int32),
        valid=np.arange(n_pad) < 5)
    z = np.zeros(n_pad)
    zi = np.zeros(n_pad, dtype=np.int32)
    usage = UsageState(z, z, z, zi, zi, zi)
    feasible = np.ones(n_pad, dtype=bool)
    kw = dict(ask=(500.0, 256.0, 150.0), eval_id="tiny", state_index=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        solve_system_arrays(matrix, usage, feasible, **kw)
    _, chosen, scores = solve_system_arrays(matrix, usage, feasible,
                                            device="cpu", **kw)
    np.testing.assert_array_equal(chosen >= 0, [True] * 5)
    assert np.isfinite(scores).all()
    stacked = [type(t)(*(np.asarray(a)[None] for a in t))
               for t in (lane.const, lane.init, lane.batch)]
    with pytest.raises(RuntimeError, match="CUDA"):
        dense.solve_placements(*stacked, spread_alg=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        system.solve_system(lane.const, lane.init, lane.batch,
                            spread_alg=False)


def test_kernel_build_is_hermetic_and_ignored_by_git():
    d = kernels.build_dir()
    assert d.is_relative_to(ROOT / "build")
    assert "build/" in (ROOT / ".gitignore").read_text().split()
    flags = " ".join(kernels.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-fmad=false" in flags and "fast_math" not in flags
    sources = {p.name for p in kernels.CSRC.glob("*.cu")}
    assert {k.source for k in kernels.KERNELS} <= sources
    for k in kernels.KERNELS:
        assert k.launches >= 0 and k.replaces.startswith("nomad_tpu/")


def test_chip_smoke_fails_without_a_card(tmp_path):
    """With no card, chip_smoke.py exits nonzero and prints no result --
    from the repository and from a directory holding only the script."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"), (tmp_path, alone)):
        r = subprocess.run([sys.executable, str(script)], cwd=cwd,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode != 0
        assert '"ok": true' not in r.stdout


@pytest.mark.parametrize("module", ["nomad_tpu_torch.scheduler.generic",
                                    "nomad_tpu_torch.scheduler.reconcile",
                                    "nomad_tpu_torch.scheduler.stack",
                                    "nomad_tpu_torch.scheduler.select",
                                    "nomad_tpu_torch.scheduler.spread",
                                    "nomad_tpu_torch.scheduler.system",
                                    "nomad_tpu_torch.scheduler.factory",
                                    "nomad_tpu_torch.scheduler.harness",
                                    "nomad_tpu_torch.scheduler.util"])
def test_scheduler_modules_load_no_jax_and_nothing_of_the_reference(
        module):
    code = (
        "import sys\n"
        f"import {module}\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'nomad_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _scheduler_world(kind, alg):
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.scheduler.harness import Harness
    from nomad_tpu_torch.structs import SchedulerConfiguration
    h = Harness()
    h.state.set_scheduler_config(
        SchedulerConfiguration(scheduler_algorithm=alg))
    for _ in range(3):
        h.state.upsert_node(mock.node())
    job = mock.system_job() if kind == "system" else mock.job()
    job.task_groups[0].count = 2
    h.state.upsert_job(job)
    ev = mock.evaluation(job_id=job.id, type=job.type)
    return h, ev


@pytest.mark.parametrize("kind", ["service", "batch", "tpu-lpq", "system",
                                  "sysbatch"])
def test_scheduler_route_defaults_to_cuda_and_raises_without_a_card(kind):
    """The port's Harness and schedulers dispatch to the card unless told
    otherwise: a tpu-* eval with no card raises (nothing carries on on
    the CPU, and nothing is committed); the same eval places with
    device="cpu", and a host algorithm never asks for the card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    alg = "tpu-lpq" if kind == "tpu-lpq" else "tpu-binpack"
    h, ev = _scheduler_world(kind, alg)
    with pytest.raises(RuntimeError, match="CUDA"):
        h.process(kind, ev)
    assert not h.plans and not h.state.allocs()
    assert h.process(kind, ev, device="cpu") is None
    assert h.evals[-1].status == "complete" and h.state.allocs()
    h, ev = _scheduler_world(kind, "binpack")
    assert h.process(kind, ev) is None and h.state.allocs()


@pytest.mark.parametrize("module", [
    "nomad_tpu_torch.state.alloc_table", "nomad_tpu_torch.server",
    "nomad_tpu_torch.server.broker", "nomad_tpu_torch.server.plan_apply",
    "nomad_tpu_torch.server.admission", "nomad_tpu_torch.server.worker",
    "nomad_tpu_torch.server.core"])
def test_server_modules_load_no_jax_and_nothing_of_the_reference(module):
    code = (
        "import sys\n"
        f"import {module}\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'nomad_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _server_threads(before):
    """The live server threads not in ``before`` (an earlier test file
    may leave its own behind)."""
    import threading
    prefixes = ("batch-worker-", "scheduler-worker-", "batch-eval-",
                "lpq-eval-", "plan-", "eval-broker-")
    return [t.name for t in threading.enumerate()
            if t.is_alive() and t not in before
            and t.name.startswith(prefixes)]


def test_server_defaults_to_cuda_and_raises_at_start_without_a_card():
    """Server() keeps the caller's device (None: cuda) and resolves it at
    start: with no card start raises, no worker starts, and nothing is
    scheduled on the CPU; device="cpu" runs."""
    import threading
    from nomad_tpu_torch.server import Server
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    before = set(threading.enumerate())
    server = Server()
    try:
        assert server.device is None
        with pytest.raises(RuntimeError, match="CUDA"):
            server.start()
        assert not server.workers and not server.is_leader()
    finally:
        server.shutdown()
    server = Server(device="cpu", num_workers=2)
    try:
        server.start()
        assert server.device == torch.device("cpu") and server.workers
    finally:
        server.shutdown()
    assert not _server_threads(before), _server_threads(before)


@pytest.mark.parametrize("module", [
    "nomad_tpu_torch.server.telemetry", "nomad_tpu_torch.server.tracing",
    "nomad_tpu_torch.solver.xferobs", "nomad_tpu_torch.server.quality"])
def test_telemetry_modules_load_no_jax_and_nothing_of_the_reference(
        module):
    """The telemetry layer's four modules, each loaded alone, pull in
    torch, numpy and the port only; the registry and the tracer load
    without the server (the solver's modules import them)."""
    code = (
        "import sys\n"
        f"import {module}\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'nomad_tpu'))\n"
        "srv = 'nomad_tpu_torch.server.core' in sys.modules\n"
        "print(bad, srv)\n"
        "sys.exit(1 if bad or srv else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("module", [
    "nomad_tpu_torch.lockcheck", "nomad_tpu_torch.jitcheck",
    "nomad_tpu_torch.statecheck", "nomad_tpu_torch.schedcheck"])
def test_sanitizer_modules_load_no_jax_and_nothing_of_the_reference(
        module):
    """The four sanitizers, each loaded alone, pull in torch, numpy and
    the port only."""
    code = (
        "import sys\n"
        f"import {module}\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'nomad_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_importing_the_port_patches_nothing_with_the_knobs_unset():
    """The sanitizers are off by default: a process that imports every
    module of the port (no NOMAD_TPU_TORCH_*CHECK set) keeps the stdlib's
    and torch's entry points as they were."""
    code = (
        "import os, queue, sys, threading, time, _thread, warnings\n"
        "import torch\n"
        "for k in list(os.environ):\n"
        "    if k.startswith('NOMAD_TPU_TORCH_') and k.endswith('CHECK'):\n"
        "        del os.environ[k]\n"
        "before = (threading.Lock, threading.RLock, threading.Condition,\n"
        "          threading.Thread.start, threading.Thread.join,\n"
        "          threading.Event.wait, threading.Event.set, time.sleep,\n"
        "          queue.Queue.get, queue.Queue.put, warnings.showwarning,\n"
        "          torch.Tensor.item, torch.Tensor.cpu,\n"
        "          torch.Tensor.__int__)\n"
        "import importlib, pkgutil, nomad_tpu_torch\n"
        "for m in pkgutil.walk_packages(nomad_tpu_torch.__path__,"
        " 'nomad_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "after = (threading.Lock, threading.RLock, threading.Condition,\n"
        "         threading.Thread.start, threading.Thread.join,\n"
        "         threading.Event.wait, threading.Event.set, time.sleep,\n"
        "         queue.Queue.get, queue.Queue.put, warnings.showwarning,\n"
        "         torch.Tensor.item, torch.Tensor.cpu,\n"
        "         torch.Tensor.__int__)\n"
        "from nomad_tpu_torch import jitcheck, lockcheck, schedcheck,"
        " statecheck\n"
        "on = [m.__name__ for m in (jitcheck, lockcheck, schedcheck,"
        " statecheck) if m.enabled()]\n"
        "print([i for i, (a, b) in enumerate(zip(before, after))"
        " if a is not b], on)\n"
        "sys.exit(1 if on or any(a is not b for a, b in"
        " zip(before, after)) else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
