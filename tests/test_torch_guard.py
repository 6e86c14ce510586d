"""The port's dispatch guard and fault points (nomad_tpu_torch/solver/guard.py,
nomad_tpu_torch/faultinject.py) on the CPU:

  * the init guard and its recovery, after tests/test_backend_guard.py: a
    hung CUDA init times out and a live one passes, the degrade ->
    observe -> reprobe -> recover cycle, a transport that is fine while
    the process is wedged, a reprobe before the first check, a late
    recovery, the subprocess probe killed at its deadline and its parsed
    device count (the init probe's question, ``_count_devices``, is
    stubbed: this machine has no card);
  * the fault drills of tests/test_chaos.py at barrier level (the server
    is not ported yet): a hang at ``solver.dispatch`` costs one deadline
    and gives every waiter DispatchFailed("timeout"), trips the breaker
    and lets it recover once the fault is disarmed; an error gives
    DispatchFailed("error"); a delay inside the deadline trips nothing;
    three faulted generations in flight at depth 3 give every waiter
    exactly one outcome; both breaker edges leave the resident set and
    the stack arena empty, and both work again afterwards;
  * LpqBarrier under the deadline;
  * the kernels' launch counts stay exact when 8 threads count at once.

Backoffs stay under 0.2 s and every join and wait is bounded.
"""
import sys
import threading
import time

import numpy as np
import pytest
import torch

from nomad_tpu_torch import faultinject, kernels
from nomad_tpu_torch.faultinject import InjectedFault, faults
from nomad_tpu_torch.solver import batch, guard, lpq, resident
from nomad_tpu_torch.solver.service import pack_lane_arrays
from nomad_tpu_torch.tensor.pack import NodeMatrix, UsageState

torch.set_num_threads(1)


def _dispatch_threads_done():
    """No watchdog runner (an abandoned one included) is still alive."""
    return not any(t.name.startswith("dispatch-")
                   for t in threading.enumerate())


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv("NOMAD_TPU_TORCH_MESH", "0")
    guard._reset_for_tests()
    faults._reset_for_tests()
    resident._reset_for_tests()
    batch.arena_clear("test")
    yield
    faults._reset_for_tests()       # releases any runner still hung
    assert _wait_for(_dispatch_threads_done), "a dispatch thread lives on"
    guard._reset_for_tests()
    resident._reset_for_tests()
    batch.arena_clear("test")


def _fast_probe_pass(monkeypatch):
    """Recovery is driven through the solver.probe fault point: the
    subprocess probe (seconds: it imports torch) is stubbed out."""
    monkeypatch.setattr(
        guard, "_subprocess_probe",
        lambda timeout: {"timed_out": False, "rc": 0, "devices": 1})


def _wait_for(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return cond()


# ----------------------------------------------------------------------
# the init guard (tests/test_backend_guard.py)

def test_guard_times_out_on_hung_init(monkeypatch):
    release = threading.Event()
    monkeypatch.setattr(guard, "_count_devices",
                        lambda: release.wait(30) and 1)
    try:
        t0 = time.monotonic()
        assert guard.backend_available(timeout_s=0.3) is False
        assert time.monotonic() - t0 < 2.0
        # pinned for the process lifetime: no second probe
        t0 = time.monotonic()
        assert guard.backend_available(timeout_s=60.0) is False
        assert time.monotonic() - t0 < 0.1
        assert guard.state()["probe_timed_out"] is True
        assert guard.dispatch_allowed() is False
    finally:
        release.set()


def test_guard_passes_on_live_backend(monkeypatch):
    monkeypatch.setattr(guard, "_count_devices", lambda: 1)
    assert guard.backend_available(timeout_s=30.0) is True
    st = guard.state()
    assert st["checked"] and st["ok"] and not st["degraded"]
    assert guard.dispatch_allowed() is True


def test_cpu_cells_need_no_probe(monkeypatch):
    def never():
        raise AssertionError("a cpu cell ran the CUDA probe")

    monkeypatch.setattr(guard, "_count_devices", never)
    assert guard.backend_available(device="cpu") is True
    assert guard.dispatch_allowed(device=["cpu", "cpu"]) is True
    assert guard.state()["checked"] is False


def test_no_card_reads_as_unavailable(monkeypatch):
    monkeypatch.setattr(guard, "_count_devices", lambda: 0)
    assert guard.backend_available(timeout_s=5.0) is False
    st = guard.state()
    assert st["checked"] and not st["ok"] and not st["probe_timed_out"]
    assert st["backend_unavailable_total"] == 1 and st["degraded"]


def test_degrade_observe_reprobe_recover(monkeypatch):
    release = threading.Event()

    def slow():
        release.wait(30)
        return 8

    monkeypatch.setattr(guard, "_count_devices", slow)
    try:
        # degrade: the probe times out while init hangs
        assert guard.backend_available(timeout_s=0.2) is False
        guard.note_host_fallback()
        guard.note_host_fallback()
        # observe
        st = guard.state()
        assert st["checked"] and not st["ok"]
        assert st["probe_timed_out"] is True
        assert st["host_fallback_dispatches"] == 2
        assert st["backend_unavailable_total"] == 1
        # the card stays wedged: a reprobe does not hang, reports the
        # subprocess verdict, and does not flip the guard
        monkeypatch.setattr(
            guard, "_subprocess_probe",
            lambda timeout: {"timed_out": True, "rc": None, "devices": 0})
        rep = guard.reprobe(timeout_s=1.0)
        assert rep["recovered"] is False
        assert rep["subprocess"]["timed_out"] is True
        assert guard.state()["ok"] is False
    finally:
        # init completes late
        release.set()
    assert _wait_for(lambda: guard._PROBE["done"].is_set(), 5.0)
    rep = guard.reprobe(timeout_s=1.0)
    assert rep["recovered"] is True
    assert guard.backend_available() is True
    st = guard.state()
    assert st["ok"] and st["recovered_late"]
    assert st["recovered_total"] == 1


def test_reprobe_reports_tunnel_ok_but_process_wedged(monkeypatch):
    hang = threading.Event()
    monkeypatch.setattr(guard, "_count_devices",
                        lambda: hang.wait(30) and 8)
    try:
        assert guard.backend_available(timeout_s=0.2) is False
        monkeypatch.setattr(
            guard, "_subprocess_probe",
            lambda timeout: {"timed_out": False, "rc": 0, "devices": 1})
        rep = guard.reprobe(timeout_s=1.0)
        assert rep["recovered"] is False
        assert rep["tunnel_ok_process_wedged"] is True
        assert guard.state()["ok"] is False
    finally:
        hang.set()


def test_reprobe_before_first_check_runs_inprocess_probe(monkeypatch):
    monkeypatch.setattr(guard, "_count_devices", lambda: 1)
    called = []
    monkeypatch.setattr(guard, "_subprocess_probe",
                        lambda t: called.append(t))
    rep = guard.reprobe(timeout_s=30.0)
    assert rep["recovered"] is False
    assert rep["subprocess"] is None and not called
    assert rep["first_probe_ok"] is True
    assert rep["state"]["checked"] is True and rep["state"]["ok"] is True
    assert guard.state()["last_reprobe"] is not None


def test_reprobe_late_recovery_direct(monkeypatch):
    guard._STATE.update(probe_timed_out=True)
    with guard._LOCK:
        guard._set_flags_locked(True, False)
    done = threading.Event()
    done.set()
    guard._PROBE["done"] = done
    guard._PROBE["result"] = {"n": 4}
    # a wedged round also tripped the breaker; recovery must clear it
    monkeypatch.setenv("NOMAD_TPU_TORCH_BREAKER_BACKOFF", "30")
    for _ in range(guard._breaker_threshold()):
        guard.record_dispatch_failure("timeout")
    assert guard.breaker_state()["state"] == guard.BREAKER_OPEN
    called = []
    monkeypatch.setattr(guard, "_subprocess_probe",
                        lambda t: called.append(t))
    rep = guard.reprobe(timeout_s=1.0)
    assert rep["recovered"] is True
    assert rep["subprocess"] is None and not called
    assert guard.backend_available() is True
    assert guard.breaker_state()["state"] == guard.BREAKER_CLOSED
    assert guard.state()["degraded"] is False


def test_subprocess_probe_timeout_kills_group(monkeypatch):
    monkeypatch.setattr(guard, "_SUBPROBE_SRC",
                        "import time\ntime.sleep(60)\n")
    t0 = time.monotonic()
    rep = guard._subprocess_probe(1.0)
    assert rep["timed_out"] is True and rep["devices"] == 0
    assert time.monotonic() - t0 < 5.0


def test_subprocess_probe_parses_device_count(monkeypatch):
    monkeypatch.setattr(guard, "_SUBPROBE_SRC", "print('N:3')\n")
    rep = guard._subprocess_probe(30.0)
    assert rep == {"timed_out": False, "rc": 0, "devices": 3}


def test_real_subprocess_probe_sees_no_card_here():
    """The probe's own source runs (imports torch from the repository
    root) and, on a machine with no card, reports none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    rep = guard._subprocess_probe(60.0)
    assert rep == {"timed_out": False, "rc": 0, "devices": 0}


def test_breaker_probe_order(monkeypatch):
    """A cpu platform's in-process answer is final; a CUDA one needs the
    init guard and then the subprocess probe; an armed solver.probe
    holds either open."""
    _fast_probe_pass(monkeypatch)
    guard._BREAKER["platform"] = "cpu"
    assert guard._breaker_probe() == (True, {"cpu_backend": True})
    faults.arm("solver.probe", "error")
    ok, rep = guard._breaker_probe()
    assert not ok and "fault_injected" in rep
    faults.disarm("solver.probe")
    guard._BREAKER["platform"] = "cuda"
    monkeypatch.setattr(guard, "_count_devices", lambda: 0)
    guard.backend_available(timeout_s=5.0)
    ok, rep = guard._breaker_probe()
    assert not ok and rep == {"in_process_ok": False}
    guard._reset_for_tests()
    monkeypatch.setattr(guard, "_count_devices", lambda: 1)
    guard.backend_available(timeout_s=5.0)
    ok, rep = guard._breaker_probe()
    assert ok and rep["subprocess"]["devices"] == 1


def test_run_dispatch_outcomes_and_counts():
    assert guard.run_dispatch(lambda: 7, device="cpu") == 7
    with pytest.raises(guard.DispatchFailed) as ei:
        guard.run_dispatch(lambda: 1 / 0, device="cpu")
    assert ei.value.kind == "error"
    assert isinstance(ei.value.__cause__, ZeroDivisionError)
    # inline (deadline <= 0): the same accounting
    assert guard.run_dispatch(lambda: 8, timeout_s=0, device="cpu") == 8
    st = guard.state()
    assert st["dispatch"] == {"ok": 2, "timeout": 0, "error": 1}
    assert st["breaker"]["consecutive_failures"] == 0
    assert st["breaker"]["platform"] == "cpu"


def test_fault_registry_actions_and_env(monkeypatch):
    reg = faultinject.FaultRegistry()
    reg.fire("solver.dispatch")                   # unarmed: a no-op
    reg.arm("solver.dispatch", "error", count=2)
    for _ in range(2):
        with pytest.raises(InjectedFault):
            reg.fire("solver.dispatch")
    reg.fire("solver.dispatch")                   # count spent: disarmed
    assert reg.snapshot() == {"faults": []}
    reg.arm("solver.dispatch", "delay", delay_s=0.05)
    t0 = time.monotonic()
    reg.fire("solver.dispatch")
    assert time.monotonic() - t0 >= 0.04
    reg.arm("solver.probe", "hang", delay_s=0.1)  # bounded hang
    reg.fire("solver.probe")
    assert {f["point"] for f in reg.snapshot()["faults"]} == {
        "solver.dispatch", "solver.probe"}
    assert reg.disarm_all() == 2
    with pytest.raises(ValueError):
        reg.arm("solver.dispatch", "explode")
    # an unbounded hang ends when the fault is disarmed
    reg.arm("solver.dispatch", "hang")
    t = threading.Thread(target=reg.fire, args=("solver.dispatch",),
                         daemon=True)
    t.start()
    assert _wait_for(lambda: reg.snapshot()["faults"][0]["fired"] == 1)
    t.join(0.05)
    assert t.is_alive()                           # parked in the hang
    assert reg.disarm("solver.dispatch") and not reg.disarm("nope")
    t.join(5)
    assert not t.is_alive()
    monkeypatch.setenv("NOMAD_TPU_TORCH_FAULT_INJECT",
                       "solver.dispatch=hang,solver.probe=delay:0.5:3,"
                       "bad,x=explode")
    snap = faultinject.FaultRegistry().snapshot()["faults"]
    assert sorted((f["point"], f["action"], f["delay_s"], f["count"])
                  for f in snap) == [
        ("solver.dispatch", "hang", 0.0, None),
        ("solver.probe", "delay", 0.5, 3)]
    assert set(faultinject.POINTS) == {
        "solver.dispatch", "solver.probe", "broker.dequeue",
        "worker.invoke", "worker.crash", "plan.apply", "plan.commit"}


# ----------------------------------------------------------------------
# fault drills at barrier level (tests/test_chaos.py)

def _matrix(n=12, n_pad=64):
    return NodeMatrix(
        n_real=n, n_pad=n_pad, node_ids=[f"g{i}" for i in range(n)],
        cpu_cap=np.r_[np.full(n, 4000.0), np.zeros(n_pad - n)],
        mem_cap=np.r_[np.full(n, 8192.0), np.zeros(n_pad - n)],
        disk_cap=np.r_[np.full(n, 102400.0), np.zeros(n_pad - n)],
        dyn_free=np.full(n_pad, 100, dtype=np.int32),
        valid=np.arange(n_pad) < n)


def _lanes(k, lo=0, count=3):
    matrix = _matrix()
    n_pad = matrix.n_pad
    z = np.zeros(n_pad)
    zi = np.zeros(n_pad, dtype=np.int32)
    usage = UsageState(z, z, z, zi, zi, zi)
    return [pack_lane_arrays(matrix, usage, np.ones(n_pad, dtype=bool),
                             ask=(500.0, 256.0, 150.0), count=count,
                             n_places=count, eval_id=f"guard-{lo + i:04d}",
                             state_index=1, device="cpu")
            for i in range(k)]


def _direct(lanes):
    """What a barrier generation must give: fuse_and_solve plus the
    cross-lane fixpoint on a fresh ledger."""
    res = batch.fuse_and_solve(lanes, device="cpu")
    batch._cross_lane_fixpoint(lanes, res, {}, device="cpu")
    return res


def _run_barrier(barrier, lanes, timeout=30.0):
    """One thread per lane; returns each thread's outcomes (a result or
    the exception) and the seconds until all were in."""
    outcomes = [[] for _ in lanes]

    def work(i):
        try:
            outcomes[i].append(barrier.solve(lanes[i]))
        except Exception as e:  # noqa: BLE001 -- the test reads it
            outcomes[i].append(e)

    ts = [threading.Thread(target=work, args=(i,), daemon=True)
          for i in range(len(lanes))]
    t0 = time.monotonic()
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout)
    assert not any(t.is_alive() for t in ts), "a waiter wedged"
    return outcomes, time.monotonic() - t0


def _assert_same(got, want):
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("depth", [1, 2])
def test_dispatch_hang_bounded_fallback_trip_and_autorecovery(
        monkeypatch, depth):
    monkeypatch.setenv("NOMAD_TPU_TORCH_DISPATCH_TIMEOUT", "0.3")
    monkeypatch.setenv("NOMAD_TPU_TORCH_BREAKER_THRESHOLD", "1")
    monkeypatch.setenv("NOMAD_TPU_TORCH_BREAKER_BACKOFF", "0.05")
    monkeypatch.setenv("NOMAD_TPU_TORCH_BREAKER_BACKOFF_MAX", "0.2")
    _fast_probe_pass(monkeypatch)
    lanes = _lanes(3)
    want = _direct(lanes)
    assert resident.stats()["entries"] > 0

    faults.arm("solver.dispatch", "hang")
    faults.arm("solver.probe", "error")
    barrier = batch.SolveBarrier(3, depth=depth, device="cpu")
    outcomes, wall = _run_barrier(barrier, lanes)
    # one deadline, not the unbounded hang; every waiter one outcome
    assert wall < 5.0, wall
    for out in outcomes:
        assert len(out) == 1
        assert isinstance(out[0], guard.DispatchFailed)
        assert out[0].kind == "timeout"
    st = guard.state()
    assert st["degraded"] is True
    assert st["breaker"]["state"] in ("open", "half_open")
    assert st["breaker"]["trips"] == 1
    assert st["dispatch"]["timeout"] == 1
    assert guard.dispatch_allowed(device="cpu") is False
    # the trip dropped the resident set and the pooled arena buffers
    assert resident.stats()["entries"] == 0
    assert batch.arena_state()["entries"] == 0

    # refilled while open (the hung runner still holds its dispatch)
    _direct(lanes)
    assert resident.stats()["entries"] > 0
    assert batch.arena_state()["entries"] == 1

    # the probe fault clears: a probe passes and the breaker closes
    # unattended, dropping the resident set and the arena again
    faults.disarm("solver.probe")
    assert _wait_for(lambda: guard.breaker_state()["state"]
                     == guard.BREAKER_CLOSED), guard.breaker_state()
    st = guard.state()
    assert st["breaker"]["recoveries"] == 1 and not st["degraded"]
    assert guard.dispatch_allowed(device="cpu") is True
    assert resident.stats()["entries"] == 0
    assert batch.arena_state()["entries"] == 0
    # the hang ends: the abandoned runner finishes its dispatch and
    # checks its arena entry in; it hands no second outcome to anyone
    faults.disarm_all()
    assert _wait_for(_dispatch_threads_done)
    assert batch.arena_state()["in_use"] == 0
    assert all(len(out) == 1 for out in outcomes)
    # and both work anew
    outcomes, _ = _run_barrier(
        batch.SolveBarrier(3, depth=depth, device="cpu"), lanes)
    _assert_same([o[0] for o in outcomes], want)
    assert resident.stats()["entries"] > 0
    assert batch.arena_state()["entries"] >= 1


def test_dispatch_error_reaches_every_waiter_under_threshold(monkeypatch):
    monkeypatch.setenv("NOMAD_TPU_TORCH_BREAKER_THRESHOLD", "100")
    lanes = _lanes(3, lo=10)
    faults.arm("solver.dispatch", "error")
    outcomes, _ = _run_barrier(batch.SolveBarrier(3, device="cpu"), lanes)
    for out in outcomes:
        assert len(out) == 1 and isinstance(out[0], guard.DispatchFailed)
        assert out[0].kind == "error"
        assert isinstance(out[0].__cause__, InjectedFault)
    st = guard.state()
    assert st["dispatch"]["error"] == 1
    assert st["breaker"]["state"] == guard.BREAKER_CLOSED
    # the staged arena entry was checked in although nothing dispatched,
    # and not pooled: its dispatch failed
    assert batch.arena_state()["in_use"] == 0
    assert batch.arena_state()["entries"] == 0


def test_dispatch_latency_within_deadline_no_trip(monkeypatch):
    monkeypatch.setenv("NOMAD_TPU_TORCH_DISPATCH_TIMEOUT", "30")
    lanes = _lanes(3, lo=20)
    want = _direct(lanes)
    faults.arm("solver.dispatch", "delay", delay_s=0.05)
    outcomes, _ = _run_barrier(batch.SolveBarrier(3, device="cpu"), lanes)
    _assert_same([o[0] for o in outcomes], want)
    st = guard.state()
    # the fused dispatch and the fixpoint, each under its own watchdog
    assert st["dispatch"] == {"ok": 2, "timeout": 0, "error": 0}
    assert st["breaker"]["state"] == guard.BREAKER_CLOSED


def test_pipelined_faulted_generations_every_waiter_one_outcome(
        monkeypatch):
    """Three barriers of two lanes at depth 3, all three generations in
    flight at once and every one faulted: each waiter sees exactly one
    DispatchFailed, and every staged arena entry goes back."""
    monkeypatch.setenv("NOMAD_TPU_TORCH_BREAKER_THRESHOLD", "100")
    faults.arm("solver.dispatch", "error")
    barriers = [batch.SolveBarrier(2, depth=3, device="cpu")
                for _ in range(3)]
    lanes = _lanes(6, lo=30)
    outcomes = [[] for _ in lanes]
    lock = threading.Lock()

    def work(i):
        try:
            res = barriers[i // 2].solve(lanes[i])
            with lock:
                outcomes[i].append(("result", res))
        except guard.DispatchFailed as e:
            with lock:
                outcomes[i].append(("failed", e.kind))
        except Exception as e:  # noqa: BLE001 -- the assertion
            with lock:
                outcomes[i].append(("unexpected", e))

    ts = [threading.Thread(target=work, args=(i,), daemon=True)
          for i in range(6)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30)
    assert not any(t.is_alive() for t in ts), "waiter wedged"
    assert outcomes == [[("failed", "error")]] * 6
    assert guard.state()["dispatch"]["error"] == 3
    assert _wait_for(_dispatch_threads_done)
    assert batch.arena_state()["in_use"] == 0


def test_trip_and_recovery_drop_resident_set_and_arena(monkeypatch):
    monkeypatch.setenv("NOMAD_TPU_TORCH_BREAKER_BACKOFF", "30")
    _fast_probe_pass(monkeypatch)
    lanes = _lanes(2, lo=40)
    batch.fuse_and_solve(lanes, device="cpu")
    assert resident.stats()["entries"] > 0
    assert batch.arena_state()["entries"] == 1
    inv0 = resident.stats()["invalidations"]
    for _ in range(guard._breaker_threshold()):
        guard.record_dispatch_failure("timeout")
    assert guard.breaker_state()["state"] == guard.BREAKER_OPEN
    assert resident.stats()["entries"] == 0
    assert batch.arena_state()["entries"] == 0
    assert resident.stats()["invalidations"] == inv0 + 1
    # refilled while open; the recovery edge drops them again
    batch.fuse_and_solve(lanes, device="cpu")
    assert resident.stats()["entries"] > 0
    guard.reset_breaker()
    assert guard.breaker_state()["state"] == guard.BREAKER_CLOSED
    assert resident.stats()["entries"] == 0
    assert batch.arena_state()["entries"] == 0
    assert resident.stats()["invalidations"] == inv0 + 2
    # and both work normally after the cycle
    batch.fuse_and_solve(lanes, device="cpu")
    before = resident.stats()
    batch.fuse_and_solve(lanes, device="cpu")
    after = resident.stats()
    assert after["hits"] > before["hits"]
    assert after["misses"] == before["misses"]
    assert batch.arena_state()["reuses"] >= 1


# ----------------------------------------------------------------------
# LpqBarrier under the deadline

def test_lpq_barrier_hang_fails_every_waiter(monkeypatch):
    monkeypatch.setenv("NOMAD_TPU_TORCH_DISPATCH_TIMEOUT", "0.3")
    monkeypatch.setenv("NOMAD_TPU_TORCH_BREAKER_THRESHOLD", "100")
    calls = []
    monkeypatch.setattr(lpq, "solve_queue", lambda ls, ledger, device=None:
                        calls.append(len(ls)) or [None] * len(ls))
    faults.arm("solver.dispatch", "hang")
    barrier = lpq.LpqBarrier(3, device="cpu")
    outcomes, wall = _run_barrier(barrier, _lanes(3, lo=50))
    assert wall < 5.0
    for out in outcomes:
        assert len(out) == 1 and isinstance(out[0], guard.DispatchFailed)
        assert out[0].kind == "timeout"
    assert guard.state()["dispatch"]["timeout"] == 1
    faults.disarm_all()
    # the abandoned runner goes on to solve once released; nobody sees it
    assert _wait_for(_dispatch_threads_done)
    assert calls == [3]
    assert all(len(out) == 1 for out in outcomes)


def test_barriers_resolve_their_cells_when_built():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        batch.SolveBarrier(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        lpq.LpqBarrier(2)
    assert guard.state()["dispatch"] == {"ok": 0, "timeout": 0, "error": 0}


# ----------------------------------------------------------------------
# launch counts under concurrent dispatches

def test_launch_counts_are_exact_across_threads():
    k = kernels.Kernel("t", "t.cu", "nomad_tpu/x.py:1 f", {})
    n_threads, per = 8, 20_000
    start = threading.Barrier(n_threads)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def bump():
            start.wait(10)
            for _ in range(per):
                k.count_launch()

        ts = [threading.Thread(target=bump, daemon=True)
              for _ in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    assert k.launches == n_threads * per
    k.reset_count()
    assert k.launches == 0
    kernels.WAVE_BLOCK.count_launch()
    kernels.reset_launches()
    assert all(kk.launches == 0 for kk in kernels.KERNELS)
