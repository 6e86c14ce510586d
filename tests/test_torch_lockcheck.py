"""The port's lock-order sanitizer (nomad_tpu_torch/lockcheck.py) on the
CPU: the reference's own tests (tests/test_lockcheck.py, less the HTTP and
CLI surfaces), each planted fault found, the same verdict as the
reference's checker on the mirrored scenarios, both packages' checkers
armed in turn in one process with ``threading`` restored after each, and
a foreign patch refused."""
import queue
import threading
import time

import _thread

import pytest

from nomad_tpu import lockcheck as ref_lockcheck
from nomad_tpu_torch import lockcheck

HERE = __file__


@pytest.fixture(autouse=True)
def _clean_checker():
    """Every test leaves the original factories restored and the state of
    both packages' checkers empty, pass or fail."""
    yield
    lockcheck.disable()
    lockcheck._reset_for_tests()
    ref_lockcheck.disable()
    ref_lockcheck._reset_for_tests()


def _globals():
    """The globals lockcheck patches, as they stand."""
    return (threading.Lock, threading.RLock, threading.Condition,
            queue.Queue.get)


def _factories_pristine():
    return (threading.Lock is lockcheck._REAL_LOCK
            and threading.RLock is lockcheck._REAL_RLOCK
            and threading.Condition is lockcheck._REAL_CONDITION)


def test_killswitch_is_inert(monkeypatch):
    """NOMAD_TPU_TORCH_LOCKCHECK=0 (or unset) is a true no-op: the
    factories are the originals and no wrapper class is observable."""
    monkeypatch.setenv("NOMAD_TPU_TORCH_LOCKCHECK", "0")
    before = _globals()
    lockcheck.maybe_install_from_env()
    assert not lockcheck.enabled()
    assert _globals() == before and _factories_pristine()
    assert isinstance(threading.Lock(), _thread.LockType)
    assert type(threading.RLock()).__module__ == "_thread"
    assert isinstance(threading.Condition(), threading.Condition)
    st = lockcheck.state()
    assert st["enabled"] is False and st["locks"] == 0


def test_env_knob_installs(monkeypatch):
    monkeypatch.setenv("NOMAD_TPU_TORCH_LOCKCHECK", "1")
    before = _globals()
    lockcheck.maybe_install_from_env()
    assert lockcheck.enabled()
    assert _globals() != before
    lockcheck.disable()
    assert _globals() == before
    assert isinstance(threading.Lock(), _thread.LockType)


def test_only_the_package_and_given_roots_are_instrumented():
    """A lock built outside nomad_tpu_torch/ (and outside the roots given
    to enable) stays raw; the port's own locks and this file's, once named,
    are wrapped."""
    lockcheck.enable()
    assert isinstance(threading.Lock(), _thread.LockType)
    from nomad_tpu_torch.state.store import StateStore
    assert type(StateStore()._lock).__name__ == "_LockWrapper"
    lockcheck.disable()
    lockcheck.enable(roots=[HERE])
    assert type(threading.Lock()).__name__ == "_LockWrapper"


def _order_ab_ba(lock_a, lock_b):
    def order_ab():
        with lock_a:
            with lock_b:
                pass

    def order_ba():
        with lock_b:
            with lock_a:
                pass

    for fn in (order_ab, order_ba):
        t = threading.Thread(target=fn)
        t.start()
        t.join()


def test_seeded_ab_ba_cycle_both_witness_stacks():
    """An AB ordering in one thread and a BA ordering in another is a
    potential deadlock though neither run deadlocks; the report carries
    the witness stack of both conflicting edges."""
    lockcheck.enable(roots=[HERE])
    _order_ab_ba(threading.Lock(), threading.Lock())
    st = lockcheck.state()
    assert st["cycle_count"] == 1
    cyc = st["cycles"][0]
    assert len(cyc["edges"]) == 2
    stacks = [e["stack"] for e in cyc["edges"]]
    assert any("order_ab" in s for s in stacks)
    assert any("order_ba" in s for s in stacks)
    assert all("test_torch_lockcheck.py" in s for s in stacks)
    assert len({e["thread"] for e in cyc["edges"]}) == 2


def test_consistent_order_and_reentry_are_clean():
    lockcheck.enable(roots=[HERE])
    lock_a, lock_b = threading.Lock(), threading.Lock()
    rlock = threading.RLock()

    def order_ab():
        with lock_a:
            with lock_b:
                with rlock:
                    with rlock:      # re-entry: no self-edge
                        pass

    for _ in range(2):
        t = threading.Thread(target=order_ab)
        t.start()
        t.join()
    with lock_a:
        with lock_b:
            pass
    st = lockcheck.state()
    assert st["cycle_count"] == 0
    assert st["edges"] >= 2


def test_cycle_metric_emitted():
    from nomad_tpu_torch.server.telemetry import metrics
    metrics.reset()
    lockcheck.enable(roots=[HERE])
    lock_a, lock_b = threading.Lock(), threading.Lock()
    with lock_a:
        with lock_b:
            pass
    with lock_b:
        with lock_a:
            pass
    assert lockcheck.state()["cycle_count"] == 1
    assert metrics.snapshot()["counters"].get("nomad.lockcheck.cycle") == 1
    metrics.reset()


def test_held_across_fire_and_dispatch():
    """Firing a fault point or entering a dispatch while holding a lock is
    the wedge-amplifier hazard."""
    from nomad_tpu_torch.faultinject import faults
    from nomad_tpu_torch.solver import guard
    lockcheck.enable(roots=[HERE])
    lk = threading.Lock()
    with lk:
        faults.fire("heartbeat")             # unarmed: still a hazard
    with lk:
        assert guard.run_dispatch(lambda: 42, timeout_s=5.0,
                                  device="cpu") == 42
    st = lockcheck.state()
    kinds = {v["kind"] for v in st["held_across"]}
    assert "faultinject.fire:heartbeat" in kinds
    assert any(k.startswith("solver.dispatch:") for k in kinds)
    for v in st["held_across"]:
        assert v["held"] and v["stack"]


def test_blocking_waits_past_threshold(monkeypatch):
    monkeypatch.setenv("NOMAD_TPU_TORCH_LOCKCHECK_WAIT_MS", "50")
    lockcheck.enable(roots=[HERE])
    lk = threading.Lock()
    q = queue.Queue()
    with lk:
        with pytest.raises(queue.Empty):
            q.get(timeout=0.12)
    cv = threading.Condition()
    with lk:
        with cv:
            cv.wait(timeout=0.12)
    # a wait holding nothing else is not a finding
    cv2 = threading.Condition()
    with cv2:
        cv2.wait(timeout=0.12)
    kinds = [v["kind"] for v in lockcheck.state()["held_across"]]
    assert kinds.count("queue.get") == 1
    assert kinds.count("condition.wait") == 1


def test_escaped_frame_bare_acquire():
    lockcheck.enable(roots=[HERE])
    lk = threading.Lock()
    release = threading.Event()

    def worker():
        def takes_and_leaks():
            lk.acquire()             # bare, escapes this frame
        takes_and_leaks()
        release.wait(5)
        lk.release()

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    deadline = time.time() + 5.0
    while not lk.locked() and time.time() < deadline:
        time.sleep(0.005)
    try:
        st = lockcheck.state()
        assert any(e["reason"] == "frame-exited"
                   and e["in_function"] == "takes_and_leaks"
                   for e in st["escaped"]), st["escaped"]
    finally:
        release.set()
        t.join()
    # a bare acquire still inside its frame is not an escape
    lockcheck._reset_for_tests()
    lk2 = threading.Lock()
    lk2.acquire()
    try:
        assert lockcheck.state()["escaped"] == []
    finally:
        lk2.release()


# ----------------------------------------------------------------------
# the same verdict as the reference's checker


def _scenario_cycle(mods):
    _order_ab_ba(threading.Lock(), threading.Lock())


def _scenario_clean(mods):
    a, b = threading.Lock(), threading.Lock()
    for _ in range(2):
        with a:
            with b:
                pass


def _scenario_fire(mods):
    lk = threading.Lock()
    with lk:
        mods["faults"].fire("heartbeat")


def _scenario_dispatch(mods):
    lk = threading.Lock()
    with lk:
        mods["dispatch"](lambda: 1)


def _scenario_escape(mods):
    lk = threading.Lock()
    box = {}

    def worker():
        def leaks():
            lk.acquire()
        leaks()
        box["st"] = mods["state"]()
        lk.release()

    t = threading.Thread(target=worker)
    t.start()
    t.join()
    return box["st"]


def _verdict(st):
    return (st["cycle_count"] > 0,
            sorted({v["kind"].split(":")[0] for v in st["held_across"]}),
            bool(st["escaped"]))


@pytest.mark.parametrize("scenario", [_scenario_cycle, _scenario_clean,
                                      _scenario_fire, _scenario_dispatch,
                                      _scenario_escape],
                         ids=["cycle", "clean", "fire", "dispatch",
                              "escape"])
def test_same_verdict_as_the_reference(scenario):
    """Each scenario under the reference's lockcheck, then under the
    port's: the same class of finding, or both clean."""
    from nomad_tpu.faultinject import faults as ref_faults
    from nomad_tpu.solver import guard as ref_guard
    from nomad_tpu_torch.faultinject import faults
    from nomad_tpu_torch.solver import guard

    ref_lockcheck.enable()
    try:
        st = scenario({"faults": ref_faults, "state": ref_lockcheck.state,
                       "dispatch": lambda fn: ref_guard.run_dispatch(
                           fn, timeout_s=5.0)})
        ref = _verdict(st or ref_lockcheck.state())
    finally:
        ref_lockcheck.disable()
        ref_lockcheck._reset_for_tests()
    assert _factories_pristine()
    lockcheck.enable(roots=[HERE])
    st = scenario({"faults": faults, "state": lockcheck.state,
                   "dispatch": lambda fn: guard.run_dispatch(
                       fn, timeout_s=5.0, device="cpu")})
    port = _verdict(st or lockcheck.state())
    assert port == ref


# ----------------------------------------------------------------------
# two packages, one threading


def test_both_packages_in_turn_restore_threading():
    """The reference's lockcheck and the port's armed in turn in one
    process: each restores the exact originals."""
    for _ in range(2):
        ref_lockcheck.enable()
        assert threading.Lock is not lockcheck._REAL_LOCK
        ref_lockcheck.disable()
        assert _factories_pristine()
        before = _globals()
        lockcheck.enable()
        assert threading.Lock is not lockcheck._REAL_LOCK
        lockcheck.disable()
        assert _globals() == before and _factories_pristine()


def test_enable_refuses_a_foreign_patch():
    """While the reference's lockcheck owns threading.Lock, the port's
    enable raises (naming the owner) and patches nothing."""
    ref_lockcheck.enable()
    try:
        with pytest.raises(RuntimeError, match="another owner"):
            lockcheck.enable()
        assert not lockcheck.enabled()
        assert threading.Lock is ref_lockcheck._lock_factory
    finally:
        ref_lockcheck.disable()
    assert _factories_pristine()
