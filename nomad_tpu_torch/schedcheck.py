"""Deterministic schedule explorer ("schedcheck") for the port's control
plane (port of nomad_tpu/schedcheck.py).

The server runs up to 32 eval threads per batch, a pipelined dispatch
barrier, the broker's delayed watcher and the group-commit applier; the
OS scheduler explores few of their interleavings on its own, so
lockcheck and statecheck catch only what happens to occur. schedcheck
makes the interleaving a controlled input:

  * while a controlled run is active, threads started by the run are
    serialized through a controller: one managed thread holds the
    "floor" at a time, and at every interposition point -- lock
    acquire / release and Condition wait / notify (through lockcheck's
    ``threading.Lock/RLock/Condition`` factory seam), ``queue.Queue``
    get / put, ``Event`` wait / set, ``Thread`` start / join,
    ``time.sleep``, the broker's delayed pops, ``guard.run_dispatch``
    entry, ``Planner.apply`` submission, ``StateStore._bump`` and
    ``apply_plan_results_batch`` -- the floor returns to the
    controller, which picks the next runnable thread by seeded PRNG
    (random walk), PCT priority change points
    (``NOMAD_TPU_TORCH_SCHEDCHECK_DEPTH``) or bounded round robin.
  * timed waits (``Condition.wait(t)``, ``Event.wait(t)``,
    ``queue.get(timeout=)``, ``time.sleep``) are virtual: the controller
    may schedule the waiter as a timeout, but only when no runnable
    thread exists, and then the earliest deadline on the run's virtual
    clock first (a 20 ms poll expires before a 120 s safety valve).
    Waits whose deadline means something in real time opt out with
    ``with schedcheck.real_time():`` -- the dispatch
    watchdog and the CUDA init probe (solver/guard.py): a virtual expiry
    would turn a healthy card dispatch into ``DispatchFailed("timeout")``.
  * the same seed gives the same decision trace (the run's fingerprint)
    and so the same placements, even with many workers. Threads outside
    the schedule (dispatch runners, the applier's pools) act at
    wall-clock times; three rules keep the fingerprint a function of
    the seed all the same: no decision is made within
    ``SETTLE_S`` (20 ms) of such an external event
    (a burst of wakes lands whole), no new virtual timeout fires while
    work handed outside the schedule is in flight (``external_begin`` /
    ``external_end``), and a thread that got the floor by a timeout --
    whose count follows the wall clock -- draws nothing from the seed's
    stream and stays out of the fingerprint until a notify wakes it.
    Every lockcheck and statecheck report recorded during a run carries
    a ``schedule`` witness (seed, policy, decision step);
    ``replay(fn, seed)`` re-runs the interleaving.
  * ``explore(fn, seeds=N)`` runs a scenario under N schedules with
    lockcheck and statecheck armed and gathers the violations;
    ``SCENARIOS`` holds the planted write skew and the planted torn
    read, built over the port's store and applier.

Liveness: a managed thread that blocks on something the controller
cannot see (a CUDA sync, a future, a ctypes launch) is handled by the
park watchdog: parked threads that see no schedule progress for
``NOMAD_TPU_TORCH_SCHEDCHECK_PARK_S`` revoke the floor, and the stuck
thread re-enters at its next interposition point (``preemptions``).

This module is also the interposition seam every port checker patches
through (``seam_install`` / ``seam_release``): each patched global is
captured when this module loads, a checker's enable refuses with a
clear error when another owner's live patch (the reference package's
sanitizers, say) is in place -- an inert one that a switched-off
checker left behind is patched over -- and the last release restores
exactly what the first install replaced. The tests import both
packages into one process, and both packages' checkers patch the same
``threading``, ``queue`` and ``time`` globals.

Off by default; ``NOMAD_TPU_TORCH_SCHEDCHECK=0`` or unset is a true
no-op: ``Thread.start/join``, ``queue.Queue.get/put``, ``Event.wait/set``
and ``time.sleep`` are the originals and no controller exists.
``NOMAD_TPU_TORCH_SCHEDCHECK=1`` at import installs the patches and
roots a controlled run at the importing thread; ``enable()`` +
``begin_run(seed)`` is how explore, replay and the test fixtures drive
it. Counters: ``nomad.schedcheck.{run,deadlock,divergence}``.

Knobs: ``NOMAD_TPU_TORCH_SCHEDCHECK`` (off; ``1`` installs at import),
``NOMAD_TPU_TORCH_SCHEDCHECK_SEED`` (0), ``NOMAD_TPU_TORCH_SCHEDCHECK_POLICY``
(random | pct | rr), ``NOMAD_TPU_TORCH_SCHEDCHECK_DEPTH`` (3: PCT change
points), ``NOMAD_TPU_TORCH_SCHEDCHECK_PARK_S`` (0.2: park watchdog),
``NOMAD_TPU_TORCH_SCHEDCHECK_TRACE`` (4096: kept decision-trace
entries), ``NOMAD_TPU_TORCH_SCHEDCHECK_MAX`` (256: kept reports).
"""
from __future__ import annotations

import hashlib
import os
import queue
import random
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

import _thread

# ----------------------------------------------------------------------
# the interposition seam: originals captured at import, owners per patch

_PRISTINE: Dict[tuple, tuple] = {}   # (obj, name) -> (value, own attr)
_OWNERS: Dict[tuple, set] = {}       # (obj, name) -> port owners
_SAVED: Dict[tuple, tuple] = {}      # what the first owner replaced


def _capture(obj, name: str) -> None:
    _PRISTINE[(obj, name)] = (getattr(obj, name), name in vars(obj))


for _obj, _name in ((threading, "Lock"), (threading, "RLock"),
                    (threading, "Condition"), (threading.Thread, "start"),
                    (threading.Thread, "join"), (threading.Event, "wait"),
                    (threading.Event, "set"), (time, "sleep"),
                    (queue.Queue, "get"), (queue.Queue, "put")):
    _capture(_obj, _name)


def _label(obj, name: str) -> str:
    return f"{getattr(obj, '__name__', type(obj).__name__)}.{name}"


def _foreign_active(cur) -> bool:
    """Whether a patch this package does not own belongs to a checker
    that is on. A checker module's ``_ACTIVE`` flag says so; a patch of
    an unknown owner counts as live."""
    mod = sys.modules.get(getattr(cur, "__module__", None) or "")
    active = getattr(mod, "_ACTIVE", None)
    return True if active is None else bool(active)


def seam_check(who: str, keys) -> None:
    """Raise when a global ``who`` would patch carries a live patch this
    package does not own. An inert one a switched-off checker left
    behind is patched over and put back on release."""
    for obj, name in keys:
        if (obj, name) not in _PRISTINE:
            _capture(obj, name)
        if _OWNERS.get((obj, name)):
            continue
        cur = getattr(obj, name)
        if cur is not _PRISTINE[(obj, name)][0] and _foreign_active(cur):
            owner = getattr(cur, "__module__", None) or repr(cur)
            raise RuntimeError(
                f"{who}: {_label(obj, name)} is patched by another owner "
                f"({owner}); disable that checker before enabling this one")


def seam_install(who: str, obj, name: str, fn) -> None:
    """Install ``fn`` over ``obj.name`` for ``who`` (after seam_check)."""
    owners = _OWNERS.setdefault((obj, name), set())
    if not owners:
        _SAVED[(obj, name)] = (getattr(obj, name), name in vars(obj))
    owners.add(who)
    setattr(obj, name, fn)


def seam_release(who: str, obj, name: str, fn=None) -> None:
    """``who`` lets go of ``obj.name``: the original comes back when no
    owner is left, else ``fn`` (the remaining owners' patch) stays."""
    owners = _OWNERS.get((obj, name))
    if not owners or who not in owners:
        return
    owners.discard(who)
    if owners:
        if fn is not None:
            setattr(obj, name, fn)
        return
    value, own = _SAVED.pop((obj, name), _PRISTINE[(obj, name)])
    if own:
        setattr(obj, name, value)
    else:
        try:
            delattr(obj, name)
        except AttributeError:
            pass


# raw primitives: the captured originals
_REAL_LOCK = _PRISTINE[(threading, "Lock")][0]
_REAL_THREAD_START = _PRISTINE[(threading.Thread, "start")][0]
_REAL_THREAD_JOIN = _PRISTINE[(threading.Thread, "join")][0]
_REAL_EVENT_WAIT = _PRISTINE[(threading.Event, "wait")][0]
_REAL_EVENT_SET = _PRISTINE[(threading.Event, "set")][0]
_REAL_SLEEP = _PRISTINE[(time, "sleep")][0]
_REAL_QUEUE_GET = _PRISTINE[(queue.Queue, "get")][0]
_REAL_QUEUE_PUT = _PRISTINE[(queue.Queue, "put")][0]

_ACTIVE = False                  # module-global fast gate (one read)

_slock = _REAL_LOCK()            # leaf: guards module state, no user
                                 # code ever runs under it

_park_s = 0.2
# the quiet time after an external event before the next decision: a
# burst of wakes (an applier resolving a group's plans) spans
# microseconds, so 20 ms holds one whole
SETTLE_S = 0.02
_trace_cap = 4096
_max_reports = 256
# consecutive zero-progress park windows a BLOCKED thread observes
# before a deadlock is declared (~8 * park_s of total quiescence)
_DEADLOCK_WINDOWS = 8

# thread names the env / fixture mode (not explore) manages: the
# control-plane actors. Everything else (dispatch runners, the
# applier's pools, telemetry) free-runs and meets them through the
# interposed primitives.
MANAGED_PREFIXES = (
    "scheduler-worker-", "batch-worker-", "batch-eval-", "lpq-eval-",
    "eval-broker-delayed",
)

# lockcheck's held-across timing of a blocking queue.get, installed by
# lockcheck.enable (one queue.Queue.get patch serves both checkers)
_LC_QUEUE_HOOK = None

_counters = {"runs": 0, "decisions": 0, "parks": 0, "preemptions": 0,
             "timeout_wakes": 0, "deadlocks": 0, "divergences": 0,
             "reports_dropped": 0}
_reports: List[dict] = []        # deadlock/divergence counterexamples
_last_run: Optional[dict] = None

_tls = threading.local()


def _metrics():
    """Telemetry sink, or None mid-teardown -- the sanitizer must
    never take the process down with it."""
    try:
        from .server.telemetry import metrics
        return metrics
    except Exception:  # noqa: BLE001
        return None


def _report(payload: dict) -> None:
    with _slock:
        if len(_reports) >= _max_reports:
            _counters["reports_dropped"] += 1
            return
        _reports.append(payload)


# ----------------------------------------------------------------------
# thread states + controller

_ST_RUNNABLE = "runnable"        # wants the floor
_ST_RUNNING = "running"          # holds the floor
_ST_BLOCKED = "blocked"          # waits for an explicit wake
_ST_TIMED = "timed"              # waits, but schedulable as a timeout
_ST_DETACHED = "detached"        # free-running (real block / revoked)
_ST_DONE = "done"


class _TState:
    __slots__ = ("serial", "name", "gate", "status", "wait_kind",
                 "wait_key", "wake_reason", "priority", "ident",
                 "stall_windows", "via_timeout", "in_real", "deadline")

    def __init__(self, serial: int, name: str):
        self.serial = serial
        self.name = name
        self.gate = threading.Event()
        self.status = _ST_RUNNABLE
        self.wait_kind = ""
        self.wait_key = None
        self.wake_reason = ""
        self.priority = 0.0
        self.ident = None
        self.stall_windows = 0
        # holds the floor through a virtual timeout: its decisions follow
        # the wall clock and stay out of the fingerprint
        self.via_timeout = False
        # in a real-blocking region it entered itself (detach), as
        # opposed to a floor the park watchdog revoked
        self.in_real = False
        # a timed wait's expiry on the run's virtual clock
        self.deadline = 0.0


class _Controller:
    """One controlled run: a seed, a policy, the floor, and the
    decision trace.  All state mutations happen under ``_mx`` (a raw
    leaf lock); parking/granting uses the per-thread raw Event gates,
    touched ONLY through the captured ``_REAL_EVENT_*`` entry points so
    the controller can never recurse into its own interposition."""

    def __init__(self, seed: int, policy: str, depth: int,
                 manage_all: bool, prefixes=MANAGED_PREFIXES):
        self._mx = _REAL_LOCK()
        self.seed = int(seed)
        self.policy = policy
        self.depth = max(0, int(depth))
        self.manage_all = manage_all
        self.prefixes = tuple(prefixes)
        self._rng = random.Random(self.seed)
        self._serial = 0
        self._by_ident: Dict[int, _TState] = {}
        self._states: List[_TState] = []
        self._floor: Optional[_TState] = None
        self.step = 0
        # (step, serial, point, fingerprinted)
        self.trace: List[tuple] = []
        self._fp = hashlib.blake2b(digest_size=16)
        self._fp.update(f"{self.seed}:{self.policy}:{self.depth}"
                        .encode())
        # bounded round-robin: the seed rotates the start offset so a
        # seed sweep still yields distinct (if few) schedules
        self._rr_next = self.seed % 8
        # PCT: the first ``depth`` change points are drawn up front so
        # the schedule is a pure function of the seed
        self._pct_points = sorted(
            self._rng.randrange(1, 4096) for _ in range(self.depth))
        self.deadlocked = False
        self.finished = False
        # deadlock detection signals: a wake through ANY patched entry
        # point (event set, queue put, lock release, cond notify --
        # callable from unmanaged threads too) bumps the wake serial;
        # scheduling a RUNNABLE thread (as opposed to spinning a
        # virtual-timeout poller) bumps the fruitful counter.  A
        # BLOCKED thread that watches BOTH freeze for a full grace
        # (while nothing runnable/detached exists) is deadlocked.
        self._wake_serial = 0
        self._fruitful = 0
        # the fingerprinted decisions: picks of runnable threads and what
        # they record; a virtual timeout's poll is counted apart, as its
        # count follows the wall clock
        self.fstep = 0
        # external events (a wake from a thread outside the schedule, a
        # managed thread back from a real-blocking region) move threads
        # at wall-clock times: no decision is made within settle_s of
        # one, so a burst of them (an applier resolving a group's
        # plans, a barrier's results) lands whole before the next pick.
        # The ticker passes a floor left vacant meanwhile.
        self.settle_s = SETTLE_S
        self._last_ext = 0.0
        self._poll_next = 0
        # virtual time: a timed wait expires at its deadline on this
        # clock, and the earliest expires first (a 20 ms poll before a
        # 120 s safety valve), whatever the wall clock did
        self._vclock = 0.0
        # work a managed thread waits on, running outside the schedule
        # (external_begin / external_end): no virtual timeout fires
        # while any is in flight or a managed thread is detached, so a
        # poll never races the wake that ends the work
        self._ext_busy = 0
        self._tick = threading.Event()
        ticker = threading.Thread(target=self._tick_loop, daemon=True,
                                  name="schedcheck-ticker")
        _REAL_THREAD_START(ticker)

    def _tick_loop(self) -> None:
        while True:
            _REAL_EVENT_WAIT(self._tick, max(self.settle_s, 1e-3))
            self._tick.clear()
            with self._mx:
                if self.finished:
                    return
                if self._floor is None and not self._deferred_locked():
                    nxt = self._pick_locked()
                    if nxt is not None:
                        self._grant_locked(nxt)

    def _deferred_locked(self) -> bool:
        return time.monotonic() - self._last_ext < self.settle_s

    def _note_external_locked(self) -> None:
        self._last_ext = time.monotonic()
        _REAL_EVENT_SET(self._tick)

    # -- registration --------------------------------------------------
    def adopt_current(self) -> _TState:
        """Register the calling thread (the run root, or a managed
        thread at begin-of-run) as RUNNING with the floor if vacant."""
        with self._mx:
            st = self._by_ident.get(_thread.get_ident())
            if st is not None:
                return st
            st = self._new_state_locked(threading.current_thread().name)
            st.ident = _thread.get_ident()
            self._by_ident[st.ident] = st
            if self._floor is None:
                st.status = _ST_RUNNING
                self._floor = st
            return st

    def _new_state_locked(self, name: str) -> _TState:
        self._serial += 1
        st = _TState(self._serial, name)
        st.priority = self._rng.random()
        self._states.append(st)
        return st

    def adopt_thread(self, thread: threading.Thread) -> _TState:
        """Register a thread at ``start()`` time (before it runs) so
        serial assignment follows creation order deterministically."""
        with self._mx:
            st = self._new_state_locked(thread.name)
            return st

    def bind_current(self, st: _TState) -> None:
        with self._mx:
            st.ident = _thread.get_ident()
            self._by_ident[st.ident] = st

    def current(self) -> Optional[_TState]:
        return self._by_ident.get(_thread.get_ident())

    def wants_thread(self, thread: threading.Thread, creator) -> bool:
        if self.manage_all:
            return creator is not None
        name = thread.name or ""
        return (any(name.startswith(p) for p in self.prefixes)
                and _port_thread(thread))

    # -- scheduling core ----------------------------------------------
    def _record_locked(self, st: _TState, point: str) -> None:
        self.step += 1
        _counters["decisions"] += 1
        if not st.via_timeout:
            self.fstep += 1
            self._fp.update(f"{self.fstep}:{st.serial}:{point};".encode())
            self._poll_next = 0
        if len(self.trace) < _trace_cap:
            self.trace.append((self.step, st.serial, point,
                               not st.via_timeout))

    def _pick_locked(self) -> Optional[_TState]:
        """The policy decision.  Pure-runnable threads always win over
        virtual-timeout wakes (a poll loop must never starve the thread
        that would make its predicate true); a timeout goes to the
        lowest serial and draws nothing from the seed's stream, so the
        picks among runnable threads stay a function of the seed however
        many polls the wall clock allowed."""
        runnable = [s for s in self._states if s.status == _ST_RUNNABLE]
        cands = sorted((s for s in runnable if not s.via_timeout),
                       key=lambda s: s.serial)
        if not cands:
            # only threads in a timeout-driven poll (they stay so until
            # a notify wakes them) or waiters that may time out: round
            # robin by serial, outside the fingerprint; no new timeout
            # while work outside the schedule is in flight
            if runnable:
                runnable.sort(key=lambda s: s.serial)
                nxt = next((s for s in runnable
                            if s.serial >= self._poll_next), runnable[0])
                self._poll_next = nxt.serial + 1
                return nxt
            if self._ext_busy or any(s.status == _ST_DETACHED and s.in_real
                                     for s in self._states):
                return None
            timed = [s for s in self._states if s.status == _ST_TIMED]
            if not timed:
                return None
            nxt = min(timed, key=lambda s: (s.deadline, s.serial))
            self._vclock = max(self._vclock, nxt.deadline)
            nxt.wake_reason = "timeout"
            nxt.via_timeout = True
            _counters["timeout_wakes"] += 1
            return nxt
        if self.policy == "rr":
            nxt = next((s for s in cands
                        if s.serial >= self._rr_next), cands[0])
            self._rr_next = nxt.serial + 1
        elif self.policy == "pct":
            if self._pct_points and self.fstep >= self._pct_points[0]:
                self._pct_points.pop(0)
                top = max(cands, key=lambda s: (s.priority, s.serial))
                top.priority = min(s.priority
                                   for s in self._states) - 1.0
            nxt = max(cands, key=lambda s: (s.priority, s.serial))
        else:
            # a pure function of (seed, fingerprinted step, candidates):
            # how many picks the wall clock added before stays out of it
            h = hashlib.blake2b(
                f"{self.seed}:{self.fstep}:"
                f"{[c.serial for c in cands]}".encode(), digest_size=8)
            nxt = cands[int.from_bytes(h.digest(), "little") % len(cands)]
        self._fruitful += 1
        return nxt

    def _grant_locked(self, st: _TState) -> None:
        st.status = _ST_RUNNING
        self._floor = st
        _REAL_EVENT_SET(st.gate)

    def _pass_floor_locked(self) -> None:
        """The floor is being given up; hand it to the next pick (or
        leave it vacant when only blocked/detached threads remain --
        an external wake through a patched entry point, or the park
        watchdog's stall detection, moves things along). Within the
        settle window of an external event the ticker makes the pick."""
        if self._deferred_locked():
            self._floor = None
            _REAL_EVENT_SET(self._tick)
            return
        nxt = self._pick_locked()
        if nxt is not None:
            self._grant_locked(nxt)
            return
        self._floor = None

    def _panic_locked(self) -> None:
        """Every managed thread waits on a wake that can never come: a
        MANIFESTED deadlock.  Record the counterexample (seed + trace)
        and release everyone to free-run (blocked cond/event waiters
        wake spuriously; predicate loops tolerate that) so the process
        survives to report it."""
        if self.deadlocked:
            return
        self.deadlocked = True
        _counters["deadlocks"] += 1
        _report({
            "kind": "deadlock",
            "schedule_seed": self.seed, "policy": self.policy,
            "step": self.step,
            "waiting": [{"thread": s.name, "serial": s.serial,
                         "on": f"{s.wait_kind}:{s.wait_key}"}
                        for s in self._states
                        if s.status == _ST_BLOCKED],
            "trace_tail": [list(t) for t in self.trace[-64:]],
        })
        for s in self._states:
            if s.status in (_ST_BLOCKED, _ST_TIMED, _ST_RUNNABLE):
                s.status = _ST_DETACHED
                s.wake_reason = "panic"
                _REAL_EVENT_SET(s.gate)
        # NOTE: no metrics emit here -- _mx is held and the telemetry
        # sink takes instrumented locks that would re-enter the
        # controller; the caller emits after releasing _mx

    # -- the thread-facing protocol -----------------------------------
    def yield_point(self, st: _TState, point: str) -> None:
        """The floor-holder offers a scheduling decision.  A detached
        thread re-enters the cooperative schedule here."""
        with self._mx:
            if self.finished:
                return
            if st.status == _ST_DETACHED:
                # back from a real-blocking region at a wall-clock time
                self._note_external_locked()
                st.in_real = False
            self._record_locked(st, point)
            st.gate.clear()
            st.status = _ST_RUNNABLE
            if self._floor is st:
                self._pass_floor_locked()
            elif self._floor is None:
                self._pass_floor_locked()
        if st.status != _ST_RUNNING:
            self._park(st)

    def block(self, st: _TState, kind: str, key, timed: bool,
              timeout: Optional[float] = None) -> str:
        """Park until an explicit ``wake`` (or, for ``timed`` waits, a
        virtual timeout ``timeout`` seconds on the run's clock).  Returns
        the wake reason."""
        with self._mx:
            if self.finished:
                return "finished"
            self._record_locked(st, f"block:{kind}")
            st.gate.clear()
            st.status = _ST_TIMED if timed else _ST_BLOCKED
            st.deadline = self._vclock + max(0.0, timeout or 0.0)
            st.wait_kind, st.wait_key = kind, key
            st.wake_reason = ""
            if self._floor is st or self._floor is None:
                self._pass_floor_locked()
        self._park(st)
        if st.wake_reason == "timeout":
            # pace virtual-timeout polls: determinism is unaffected
            # (the decision already happened), but an unbounded poll
            # spin must not burn the whole core
            _REAL_SLEEP(0.001)
        return st.wake_reason or "granted"

    def wake(self, kind: str, key, n: Optional[int] = None) -> int:
        """Make threads blocked on (kind, key) runnable.  Callable from
        ANY thread (including unmanaged ones: a free-running HTTP
        handler notifying a managed worker's condvar) -- it only flips
        states; the floor moves at the next decision, or immediately
        when it is vacant."""
        woken = 0
        if n is not None and n <= 0:
            return 0
        with self._mx:
            if self.finished:
                return 0
            me = self._by_ident.get(_thread.get_ident())
            external = me is None or me.status == _ST_DETACHED
            for s in sorted(self._states, key=lambda s: s.serial):
                if s.status in (_ST_BLOCKED, _ST_TIMED) and \
                        s.wait_kind == kind and s.wait_key == key:
                    s.status = _ST_RUNNABLE
                    s.wake_reason = "notified"
                    s.via_timeout = False
                    woken += 1
                    if n is not None and woken >= n:
                        break
            if woken:
                # only wakes that woke SOMEONE count as progress for
                # the deadlock accrual: background releases/sets with
                # no virtual waiters (leaked test threads, telemetry
                # flushers) must not mask a real circular wait forever
                self._wake_serial += 1
                if external:
                    self._note_external_locked()
                if self._floor is None:
                    self._pass_floor_locked()
        return woken

    def _park(self, st: _TState) -> None:
        """Wait for the floor.  The park watchdog: if the schedule
        makes NO progress for a full park window while we sit parked,
        the floor-holder is stuck in something the controller cannot
        see -- revoke the floor (the stuck thread detaches and
        re-enters at its next interposition point) so the run keeps
        moving."""
        _counters["parks"] += 1
        last_step = -1
        last_progress = (-1, -1)      # (fruitful, wake_serial)
        while True:
            if _REAL_EVENT_WAIT(st.gate, _park_s):
                st.gate.clear()
                st.stall_windows = 0
                return
            with self._mx:
                if self.finished or st.status == _ST_DETACHED:
                    if st.status != _ST_DONE:
                        st.status = _ST_DETACHED
                    return
                if st.status == _ST_RUNNING:
                    continue          # granted between wait and lock
                if self.step == last_step:
                    self._stalled_locked(st)
                elif self._floor is None:
                    self._pass_floor_locked()
                # deadlock accrual: I am parked on an explicit wake,
                # and for this whole window nothing fruitful ran and
                # nothing woke anyone -- the system is only spinning
                # virtual-timeout pollers (or fully idle)
                declared = False
                progress = (self._fruitful, self._wake_serial)
                if st.status == _ST_BLOCKED and \
                        progress == last_progress and \
                        not any(s.status in (_ST_RUNNABLE,
                                             _ST_DETACHED)
                                for s in self._states):
                    st.stall_windows += 1
                    if st.stall_windows >= _DEADLOCK_WINDOWS:
                        already = self.deadlocked
                        self._panic_locked()
                        declared = not already
                else:
                    st.stall_windows = 0
                last_step = self.step
                last_progress = progress
            if declared:
                # emit OUTSIDE _mx with interposition suppressed (the
                # telemetry sink takes instrumented locks)
                _tls.in_ctl = True
                try:
                    m = _metrics()
                    if m is not None:
                        m.incr("nomad.schedcheck.deadlock")
                finally:
                    _tls.in_ctl = False

    def _stalled_locked(self, st: _TState) -> None:
        """A full park window passed with zero decisions: the
        floor-holder is wedged outside the interposition set -> revoke
        the floor (it re-enters at its next yield point) so the run
        keeps moving.  (Deadlock among BLOCKED threads is the separate
        accrual in _park -- a vacant floor with only blocked threads
        is normal while an unmanaged thread works toward a wake.)"""
        holder = self._floor
        if holder is not None:
            _counters["preemptions"] += 1
            holder.status = _ST_DETACHED
            self._floor = None
        self._pass_floor_locked()

    def thread_begin(self, st: _TState) -> None:
        self.bind_current(st)
        with self._mx:
            if self.finished:
                st.status = _ST_DETACHED
                return
            st.status = _ST_RUNNABLE
            if self._floor is None:
                self._pass_floor_locked()
        if st.status != _ST_RUNNING:
            self._park(st)

    def thread_end(self, st: _TState) -> None:
        with self._mx:
            held = self._floor is st
            st.status = _ST_DONE
            self._wake_serial += 1
            for s in self._states:
                if s.status in (_ST_BLOCKED, _ST_TIMED) and \
                        s.wait_kind == "join" and s.wait_key == st:
                    s.status = _ST_RUNNABLE
                    s.wake_reason = "notified"
                    s.via_timeout = False
            if held or self._floor is None:
                self._floor = None
                self._pass_floor_locked()

    def detach(self, st: _TState) -> None:
        """Enter a real-blocking region: give up the floor and
        free-run until the next interposition point."""
        with self._mx:
            if self.finished:
                return
            self._record_locked(st, "detach")
            st.status = _ST_DETACHED
            st.in_real = True
            if self._floor is st:
                self._floor = None
                self._pass_floor_locked()

    def finish(self) -> dict:
        """End the run: release every parked thread to free-run and
        freeze the summary."""
        with self._mx:
            self.finished = True
            summary = {
                "seed": self.seed, "policy": self.policy,
                "depth": self.depth, "decisions": self.step,
                "fingerprinted_decisions": self.fstep,
                "fingerprint": self._fp.hexdigest(),
                "threads": len(self._states),
                "deadlocked": self.deadlocked,
                "trace_tail": [list(t) for t in self.trace[-64:]],
            }
            for s in self._states:
                if s.status not in (_ST_DONE,):
                    s.status = _ST_DETACHED
                _REAL_EVENT_SET(s.gate)
            self._floor = None
            _REAL_EVENT_SET(self._tick)
        return summary


_ctl: Optional[_Controller] = None


def _port_thread(thread: threading.Thread) -> bool:
    """Whether the thread runs this package's code (its class, or its
    target's module): the reference package's server, run beside the
    port's in one process, names its threads alike."""
    fn = getattr(thread, "_target", None)
    mod = (type(thread).__module__ if fn is None
           else getattr(fn, "__module__", "") or "")
    return mod.split(".")[0] == __name__.split(".")[0]


def _cur() -> Optional[_TState]:
    """The calling thread's managed state, or None (fast path: one
    module-global read when the checker is off)."""
    ctl = _ctl
    if ctl is None or ctl.finished:
        return None
    if getattr(_tls, "in_ctl", False):
        return None
    return ctl.current()


# ----------------------------------------------------------------------
# interposition API (called from lockcheck wrappers and the repo's
# marker sites; every entry is gated on _ACTIVE by the caller or here)


def yield_point(point: str) -> None:
    """A scheduling decision: the floor-holder pauses and the policy
    picks the next runnable thread (possibly the same one)."""
    if not _ACTIVE:
        return
    ctl, st = _ctl, _cur()
    if ctl is None or st is None:
        return
    ctl.yield_point(st, point)


def lock_gate(inner, point: str = "lock.acquire", owner=None) -> None:
    """Deterministic lock handoff: yield, then wait (virtually) while
    the inner primitive is held by another thread of the schedule.  The
    caller performs the real acquire after we return -- uncontended by
    construction, since only one managed thread runs at a time and the
    release hook wakes us. A holder outside the schedule (``owner``'s
    ``_lc_owner``, lockcheck's wrapper) is waited for for real with the
    floor kept: it needs no floor to release, and a pass here would
    hang the schedule on its wall-clock timing."""
    if not _ACTIVE:
        return
    ctl, st = _ctl, _cur()
    if ctl is None or st is None:
        return
    ctl.yield_point(st, point)
    stalls = 0
    while not _probe_free(inner):
        holder = getattr(owner, "_lc_owner", 0)
        hs = ctl._by_ident.get(holder) if holder else None
        if hs is None or hs.status in (_ST_DETACHED, _ST_DONE):
            return            # the caller's real acquire waits for it
        # timed: a release by an unmanaged thread may not wake us, so
        # stay schedulable and re-probe
        reason = ctl.block(st, "lock", id(inner), timed=True)
        if reason in ("panic", "finished"):
            return            # the caller's real acquire blocks for real
        if reason == "timeout":
            # the holder is outside the schedule (detached/unmanaged):
            # pace the re-probe so the spin does not burn a core
            stalls += 1
            if stalls > 2:
                _REAL_SLEEP(0.001)


def external_begin() -> None:
    """A managed thread handed work to a thread outside the schedule
    (a barrier generation to the dispatch pipeline, a plan to the
    applier) and will wait for it: no virtual timeout until it ends."""
    if not _ACTIVE:
        return
    ctl = _ctl
    if ctl is None or ctl.finished:
        return
    with ctl._mx:
        ctl._ext_busy += 1


def external_end() -> None:
    """The work of one external_begin ended (its wake is the external
    event that starts the settle window)."""
    if not _ACTIVE:
        return
    ctl = _ctl
    if ctl is None or ctl.finished:
        return
    with ctl._mx:
        ctl._ext_busy = max(0, ctl._ext_busy - 1)
        ctl._note_external_locked()


def lock_released(inner) -> None:
    if not _ACTIVE:
        return
    ctl = _ctl
    if ctl is None or ctl.finished:
        return
    ctl.wake("lock", id(inner))
    st = _cur()
    if st is not None:
        ctl.yield_point(st, "lock.release")


def _probe_free(inner) -> bool:
    """Whether the raw Lock/RLock could be acquired without blocking
    (includes RLock re-entry by the probing thread)."""
    if inner.acquire(False):
        inner.release()
        return True
    return False


def cond_wait_gate(cond_id: int, timed: bool,
                   timeout: Optional[float] = None) -> bool:
    """Virtual Condition.wait: park until notify (or a virtual timeout
    for timed waits).  Returns True when notified."""
    ctl, st = _ctl, _cur()
    if ctl is None or st is None:
        return True
    reason = ctl.block(st, "cond", cond_id, timed=timed, timeout=timeout)
    return reason == "notified"


def cond_notify(cond_id: int, n: Optional[int]) -> None:
    ctl = _ctl
    if ctl is None or ctl.finished:
        return
    ctl.wake("cond", cond_id, n=n)


def managed_active() -> bool:
    """Whether the calling thread is under the controller right now
    (the lockcheck wrappers route their wait/acquire through the
    virtual protocol only when this holds)."""
    return _ACTIVE and _cur() is not None


class _RealBlock:
    """``with schedcheck.real_block():`` -- the body performs real
    blocking the controller cannot interpose (socket, future, foreign
    compute): detach for the duration, re-enter at exit."""

    def __enter__(self):
        ctl, st = _ctl, _cur()
        self._st = st if ctl is not None else None
        if self._st is not None:
            ctl.detach(self._st)
        return self

    def __exit__(self, *exc):
        st = self._st
        ctl = _ctl
        if st is not None and ctl is not None and not ctl.finished:
            ctl.yield_point(st, "real_block.exit")
        return False


def real_block() -> _RealBlock:
    return _RealBlock()


class _RealTime:
    """``with schedcheck.real_time():`` -- timed waits in the body keep
    REAL timeout semantics (the dispatch watchdog deadline must not
    fire virtually early); the thread detaches for the duration."""

    def __enter__(self):
        self._prev = getattr(_tls, "real_time", 0)
        _tls.real_time = self._prev + 1
        self._rb = _RealBlock().__enter__()
        return self

    def __exit__(self, *exc):
        _tls.real_time = self._prev
        self._rb.__exit__(*exc)
        return False


def real_time() -> _RealTime:
    return _RealTime()


def _in_real_time() -> bool:
    return bool(getattr(_tls, "real_time", 0))


def witness() -> Optional[dict]:
    """The schedule witness attached to every lockcheck/statecheck
    report recorded during a controlled run: replaying the seed
    reproduces the interleaving that manifested the violation."""
    ctl = _ctl
    if not _ACTIVE or ctl is None or ctl.finished:
        return None
    return {"schedule_seed": ctl.seed, "policy": ctl.policy,
            "step": ctl.step}


# ----------------------------------------------------------------------
# patched stdlib entry points (installed by enable(); every wrapper
# falls through to the real call unless the CURRENT thread is managed)


def _patched_thread_start(self):
    ctl = _ctl
    if _ACTIVE and ctl is not None and not ctl.finished and \
            not getattr(self, "_sc_state", None):
        creator = _cur()
        if ctl.wants_thread(self, creator):
            st = ctl.adopt_thread(self)
            self._sc_state = st
            run = self.run

            def _managed_run():
                ctl.thread_begin(st)
                try:
                    run()
                finally:
                    ctl.thread_end(st)

            self.run = _managed_run
    # start() waits for the new thread's bootstrap: a real wait with the
    # floor kept, so the spawn's wall-clock latency decides nothing
    _tls.hold_floor = getattr(_tls, "hold_floor", 0) + 1
    try:
        return _REAL_THREAD_START(self)
    finally:
        _tls.hold_floor -= 1


def _patched_thread_join(self, timeout=None):
    ctl, st = _ctl, _cur()
    if st is None or ctl is None:
        return _REAL_THREAD_JOIN(self, timeout)
    target = getattr(self, "_sc_state", None)
    if target is not None:
        # virtual join on a managed target: wait for its thread_end
        while self.is_alive() and target.status != _ST_DONE:
            reason = ctl.block(st, "join", target,
                               timed=timeout is not None, timeout=timeout)
            if reason == "timeout" and timeout is not None:
                return            # virtual expiry; caller re-checks
            if reason in ("panic", "finished"):
                with real_block():
                    return _REAL_THREAD_JOIN(self, timeout)
        return _REAL_THREAD_JOIN(self, 0.05)
    with real_block():
        return _REAL_THREAD_JOIN(self, timeout)


def _patched_event_wait(self, timeout=None):
    ctl, st = _ctl, _cur()
    if getattr(_tls, "hold_floor", 0):
        return _REAL_EVENT_WAIT(self, timeout)
    if st is None or ctl is None or _in_real_time():
        if _in_real_time() and _cur() is not None:
            with real_block():
                return _REAL_EVENT_WAIT(self, timeout)
        return _REAL_EVENT_WAIT(self, timeout)
    while not self.is_set():
        reason = ctl.block(st, "event", id(self),
                           timed=timeout is not None, timeout=timeout)
        if reason == "timeout":
            break                 # a legit (virtual) timeout expiry
        if reason == "panic":
            break                 # manifested deadlock: wake spuriously
                                  # so the wedge surfaces instead of
                                  # parking on a set() that never comes
        if reason == "finished":
            return _REAL_EVENT_WAIT(self, timeout)
    return self.is_set()


def _patched_event_set(self):
    _REAL_EVENT_SET(self)
    ctl = _ctl
    if _ACTIVE and ctl is not None and not ctl.finished:
        ctl.wake("event", id(self))


def _patched_sleep(secs):
    ctl, st = _ctl, _cur()
    if st is None or ctl is None or _in_real_time() or secs <= 0:
        return _REAL_SLEEP(secs)
    # virtual sleep: one schedulable timeout event, no wall clock
    ctl.block(st, "sleep", None, timed=True, timeout=secs)


def _sc_queue_get(self, block=True, timeout=None):
    ctl, st = _ctl, _cur()
    if st is None or ctl is None or not block:
        return _REAL_QUEUE_GET(self, block, timeout)
    while True:
        ctl.yield_point(st, "queue.get")
        try:
            return _REAL_QUEUE_GET(self, False)
        except queue.Empty:
            reason = ctl.block(st, "queue", id(self),
                               timed=timeout is not None, timeout=timeout)
            if reason == "timeout" and timeout is not None:
                raise
            if reason == "panic":
                raise             # deadlock: surface as Empty rather
                                  # than park on a put() never coming
            if reason == "finished":
                return _REAL_QUEUE_GET(self, block, timeout)


def _patched_queue_get(self, block=True, timeout=None):
    """The one queue.Queue.get patch: lockcheck's held-across timing
    (when lockcheck is on) around schedcheck's virtual get (a plain get
    outside a controlled run)."""
    hook = _LC_QUEUE_HOOK
    if hook is not None:
        return hook(self, block, timeout, _sc_queue_get)
    return _sc_queue_get(self, block, timeout)


def _patched_queue_put(self, item, block=True, timeout=None):
    ctl, st = _ctl, _cur()
    if st is not None and ctl is not None:
        ctl.yield_point(st, "queue.put")
    out = _REAL_QUEUE_PUT(self, item, block, timeout)
    if _ACTIVE and ctl is not None and not ctl.finished:
        ctl.wake("queue", id(self))
    return out


# ----------------------------------------------------------------------
# lifecycle

_PATCHES = ((threading.Thread, "start", _patched_thread_start),
            (threading.Thread, "join", _patched_thread_join),
            (threading.Event, "wait", _patched_event_wait),
            (threading.Event, "set", _patched_event_set),
            (time, "sleep", _patched_sleep),
            (queue.Queue, "get", _patched_queue_get),
            (queue.Queue, "put", _patched_queue_put))


def enabled() -> bool:
    return _ACTIVE


def enable() -> None:
    """Install the interposition patches (refused when another owner's
    patch is on one of them). They are inert (one module-global read,
    then a thread-registry miss) for every thread outside a controlled
    run."""
    global _ACTIVE, _park_s, _trace_cap, _max_reports
    with _slock:
        if _ACTIVE:
            return
        seam_check("schedcheck", [(o, n) for o, n, _ in _PATCHES])
        _park_s = float(os.environ.get(
            "NOMAD_TPU_TORCH_SCHEDCHECK_PARK_S", "0.2"))
        _trace_cap = int(os.environ.get(
            "NOMAD_TPU_TORCH_SCHEDCHECK_TRACE", "4096"))
        _max_reports = int(os.environ.get(
            "NOMAD_TPU_TORCH_SCHEDCHECK_MAX", "256"))
        for obj, name, fn in _PATCHES:
            seam_install("schedcheck", obj, name, fn)
        _ACTIVE = True


def disable() -> None:
    """Restore the original entry points (queue.Queue.get stays patched
    while lockcheck is on). A run still active is finished first so no
    thread stays parked."""
    global _ACTIVE
    if not _ACTIVE:
        return
    end_run()
    _ACTIVE = False
    for obj, name, fn in _PATCHES:
        seam_release("schedcheck", obj, name, fn)


def begin_run(seed: int = 0, policy: Optional[str] = None,
              depth: Optional[int] = None,
              manage_all: bool = False, root: bool = True) -> None:
    """Start a controlled run rooted at the calling thread.  Threads
    the root (transitively) starts are managed when ``manage_all``
    (explore/replay scenarios), else by the MANAGED_PREFIXES allowlist
    (env/fixture mode over live suites). ``root`` False leaves the
    calling thread outside the schedule (a test that also drives the
    reference package keeps its real clock)."""
    global _ctl
    if not _ACTIVE:
        enable()
    end_run()
    policy = policy or os.environ.get(
        "NOMAD_TPU_TORCH_SCHEDCHECK_POLICY", "random")
    if depth is None:
        depth = int(os.environ.get("NOMAD_TPU_TORCH_SCHEDCHECK_DEPTH", "3"))
    ctl = _Controller(seed, policy, depth, manage_all)
    if root:
        ctl.adopt_current()
    with _slock:
        _counters["runs"] += 1
    _ctl = ctl
    m = _metrics()
    if m is not None:
        m.incr("nomad.schedcheck.run")


def end_run() -> Optional[dict]:
    """Finish the active run (if any) and return its summary."""
    global _ctl, _last_run
    ctl = _ctl
    if ctl is None:
        return None
    _ctl = None
    summary = ctl.finish()
    with _slock:
        _last_run = summary
    return summary


def maybe_install_from_env() -> None:
    if os.environ.get("NOMAD_TPU_TORCH_SCHEDCHECK", "0") == "1":
        enable()
        begin_run(seed=int(os.environ.get(
            "NOMAD_TPU_TORCH_SCHEDCHECK_SEED", "0")))


# ----------------------------------------------------------------------
# exploration driver + replay


class RunResult:
    __slots__ = ("seed", "policy", "fingerprint", "decisions",
                 "violations", "summary", "error")

    def __init__(self, seed, policy, fingerprint, decisions,
                 violations, summary, error=None):
        self.seed = seed
        self.policy = policy
        self.fingerprint = fingerprint
        self.decisions = decisions
        self.violations = violations
        self.summary = summary
        self.error = error

    def to_dict(self) -> dict:
        return {"seed": self.seed, "policy": self.policy,
                "fingerprint": self.fingerprint,
                "decisions": self.decisions,
                "violations": self.violations,
                "error": repr(self.error) if self.error else None}


class ExploreResult:
    __slots__ = ("runs", "violations")

    def __init__(self, runs: List[RunResult]):
        self.runs = runs
        self.violations = [v for r in runs for v in r.violations]

    @property
    def seeds_with_violations(self) -> List[int]:
        return sorted({r.seed for r in self.runs if r.violations})

    def to_dict(self) -> dict:
        return {"runs": [r.to_dict() for r in self.runs],
                "violation_count": len(self.violations),
                "seeds_with_violations": self.seeds_with_violations}


def _collect_violations() -> List[dict]:
    """Harvest the hard findings the armed sanitizers recorded during
    one controlled run, normalized to (checker, kind, witness...)."""
    out: List[dict] = []
    from . import lockcheck, statecheck
    lc = lockcheck.state()
    for c in lc.get("cycles") or []:
        out.append({"checker": "lockcheck", "kind": "cycle",
                    "locks": c.get("locks"),
                    "schedule": c.get("schedule")})
    sc = statecheck.state()
    for key, kind in (("torn_reads", "torn_read"),
                      ("aliasing_writes", "aliasing_write"),
                      ("write_skews", "write_skew"),
                      ("journal_gaps", "journal_gap"),
                      ("stale_memos", "stale_memo")):
        for r in sc.get(key) or []:
            v = {"checker": "statecheck", "kind": kind,
                 "schedule": r.get("schedule")}
            for f in ("op", "site", "versions", "node", "plans",
                      "detail"):
                if r.get(f) is not None:
                    v[f] = r[f]
            out.append(v)
    return out


def run_schedule(fn: Callable[[], None], seed: int,
                 policy: Optional[str] = None,
                 depth: Optional[int] = None) -> RunResult:
    """One controlled run of ``fn`` under (seed, policy) with
    lockcheck + statecheck armed; returns the violations each carrying
    the schedule witness."""
    from . import lockcheck, statecheck
    lc_was, sc_was = lockcheck.enabled(), statecheck.enabled()
    if not lc_was:
        lockcheck.enable()
    if not sc_was:
        statecheck.enable()
    enable()
    begin_run(seed, policy=policy, depth=depth, manage_all=True)
    error = None
    try:
        fn()
    except Exception as e:  # noqa: BLE001 -- the run result carries it
        error = e
    summary = end_run()
    violations = _collect_violations()
    if summary.get("deadlocked"):
        violations.append({
            "checker": "schedcheck", "kind": "deadlock",
            "schedule": {"schedule_seed": seed,
                         "policy": summary["policy"],
                         "step": summary["decisions"]}})
    lockcheck._reset_for_tests()
    statecheck._reset_for_tests()
    if not lc_was:
        lockcheck.disable()
    if not sc_was:
        statecheck.disable()
    return RunResult(seed, summary["policy"], summary["fingerprint"],
                     summary["decisions"], violations, summary, error)


def explore(fn: Callable[[], None], seeds=16,
            policy: Optional[str] = None,
            depth: Optional[int] = None) -> ExploreResult:
    """Run ``fn`` under N seeded schedules (``seeds`` is a count or an
    iterable of seeds) and aggregate the violations."""
    seed_list = (list(range(seeds)) if isinstance(seeds, int)
                 else list(seeds))
    runs = [run_schedule(fn, s, policy=policy, depth=depth)
            for s in seed_list]
    return ExploreResult(runs)


def replay(fn: Callable[[], None], seed: int,
           policy: Optional[str] = None,
           depth: Optional[int] = None,
           expect_fingerprint: Optional[str] = None) -> RunResult:
    """Re-run the exact interleaving a violation reported.  When the
    caller pins the expected schedule fingerprint, a divergence (the
    scenario itself changed between record and replay) is counted and
    reported."""
    result = run_schedule(fn, seed, policy=policy, depth=depth)
    if expect_fingerprint is not None and \
            result.fingerprint != expect_fingerprint:
        with _slock:
            _counters["divergences"] += 1
        _report({"kind": "divergence", "schedule_seed": seed,
                 "expected": expect_fingerprint,
                 "got": result.fingerprint})
        m = _metrics()
        if m is not None:
            m.incr("nomad.schedcheck.divergence")
    return result


# ----------------------------------------------------------------------
# built-in scenarios, over the port's store, applier and broker (the
# gauntlet's targets; the planted-* ones SEED the bug they are named for)


def _world():
    from . import mock
    from .state.store import StateStore

    store = StateStore()
    node = mock.node()
    node.id = "sched-node-0000"
    node.compute_class()
    store.upsert_node(node)
    job = mock.job(id="sched-job")
    return store, node, job


def scenario_broker_smoke() -> None:
    """Clean scenario: two workers race dequeues off one broker and
    commit disjoint single-plan batches.  Zero violations expected
    under every schedule."""
    from . import mock
    from .server.broker import EvalBroker
    from .structs import PlanResult

    store, node, job = _world()
    broker = EvalBroker()
    broker.set_enabled(True)
    evs = []
    for k in range(4):
        ev = mock.evaluation(job_id=f"smoke-job-{k}")
        ev.id = f"smoke-eval-{k}-" + "0" * 18
        evs.append(ev)
    broker.enqueue_all(evs)

    def worker(k):
        for _ in range(2):
            ev, token = broker.dequeue(["service"], timeout=0.2)
            if ev is None:
                continue
            a = mock.alloc_for(job, node, index=hash(ev.id) % 97)
            a.eval_id = ev.id
            store.apply_plan_results_batch(
                [(PlanResult(node_allocation={node.id: [a]}), None)])
            broker.ack(ev.id, token)

    threads = [threading.Thread(target=worker, args=(k,),
                                daemon=True, name=f"smoke-worker-{k}")
               for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        while t.is_alive():
            t.join(timeout=5.0)
    broker.shutdown()


def scenario_planted_write_skew() -> None:
    """PLANTED BUG: two workers claim a node through a check-then-act
    whose check runs OUTSIDE the claim lock (the disjointness check is
    bypassed).  Under the racy interleaving both claims land in ONE
    ``apply_plan_results_batch`` transaction touching the same node --
    statecheck's write-skew witness.  Uncontrolled, the racy window is
    a few bytecodes wide and the OS never splits it."""
    from . import mock
    from .structs import PlanResult

    store, node, job = _world()
    claimed: set = set()
    batch: list = []
    claim_lock = threading.Lock()

    def worker(k):
        a = mock.alloc_for(job, node, index=k)
        a.eval_id = f"skew-eval-{k}-" + "0" * 16
        if node.id not in claimed:          # racy read (the bug)
            with claim_lock:
                claimed.add(node.id)
                batch.append(
                    (PlanResult(node_allocation={node.id: [a]}), None))

    threads = [threading.Thread(target=worker, args=(k,),
                                daemon=True, name=f"skew-worker-{k}")
               for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        while t.is_alive():
            t.join(timeout=5.0)
    if batch:
        store.apply_plan_results_batch(batch)


def scenario_planted_torn_read() -> None:
    """PLANTED BUG: a verifier opens a strict scope but drops the store
    lock between its two fold reads; a committer that lands in the gap
    makes the verifier observe two table versions inside one strict
    scope -- statecheck's torn read.  The committer thread is only
    SPAWNED once the first read completed, so an uncontrolled run can
    never collide (thread spawn latency dwarfs the microsecond gap);
    under a controlled schedule the spawn is itself a decision point
    and the commit can land squarely in the gap."""
    from . import mock, statecheck

    store, node, job = _world()
    store.upsert_allocs([mock.alloc_for(job, node)])
    r1_done = threading.Event()

    def verifier():
        with statecheck.strict_scope("schedcheck.gauntlet"):
            with store._lock:
                store.alloc_table.fold_verify([node.id])
            r1_done.set()
            # the planted bug: the lock is dropped mid-verify
            with store._lock:
                store.alloc_table.fold_verify([node.id])

    def committer():
        store.upsert_allocs([mock.alloc_for(job, node, index=1)])

    vt = threading.Thread(target=verifier, daemon=True,
                          name="torn-verifier")
    vt.start()
    r1_done.wait(5.0)
    ct = threading.Thread(target=committer, daemon=True,
                          name="torn-committer")
    ct.start()
    for t in (vt, ct):
        while t.is_alive():
            t.join(timeout=5.0)


SCENARIOS: Dict[str, Callable[[], None]] = {
    "broker-smoke": scenario_broker_smoke,
    "planted-write-skew": scenario_planted_write_skew,
    "planted-torn-read": scenario_planted_torn_read,
}


# ----------------------------------------------------------------------
# reporting


def state() -> dict:
    """Full checker state (capped)."""
    ctl = _ctl
    with _slock:
        return {
            "enabled": _ACTIVE,
            "run_active": bool(ctl is not None and not ctl.finished),
            "seed": ctl.seed if ctl is not None else None,
            "policy": ctl.policy if ctl is not None else None,
            "depth": ctl.depth if ctl is not None else None,
            "park_s": _park_s,
            "runs": _counters["runs"],
            "decisions": _counters["decisions"],
            "parks": _counters["parks"],
            "preemptions": _counters["preemptions"],
            "timeout_wakes": _counters["timeout_wakes"],
            "deadlock_count": _counters["deadlocks"],
            "divergence_count": _counters["divergences"],
            "reports_dropped": _counters["reports_dropped"],
            "threads_managed": (len(ctl._states)
                                if ctl is not None else 0),
            "last_run": dict(_last_run) if _last_run else None,
            "reports": [dict(r) for r in _reports],
        }


def _reset_for_tests() -> None:
    global _last_run
    end_run()
    with _slock:
        _reports.clear()
        _last_run = None
        for k in _counters:
            _counters[k] = 0
