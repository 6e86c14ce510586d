"""Named fault-injection points (port of nomad_tpu/faultinject.py).

A component that can hang, fail or lag declares a named point and fires
it; a test (or an operator, through the environment) arms a fault there
and checks that the system degrades as designed: a dispatch that hangs
costs one watchdog deadline and trips the breaker, the breaker recovers
once the fault is gone.

Points fired by the port:

  solver.dispatch   solver/guard.py run_dispatch -- fires INSIDE the
                    watchdog, so a hang exercises the timeout path
  solver.probe      solver/guard.py -- the breaker's recovery probe; an
                    armed fault keeps the breaker open
  broker.dequeue    server/broker.py dequeue / dequeue_batch -- stalls or
                    fails the eval feed
  worker.invoke     server/worker.py invoke_scheduler -- an error takes
                    the orderly nack path
  worker.crash      server/worker.py -- an error kills the worker thread
                    after the lease was minted (WorkerCrash), leaving the
                    eval to the broker's nack-timeout redelivery
  plan.apply        server/plan_apply.py Planner.apply -- an error nacks
                    the submitting eval
  plan.commit       state/store.py apply_plan_results_batch -- fires
                    before each plan's writes; the group splits around it
  quality.skew      server/quality.py shadow-audit capture -- an armed
                    error skews the captured scores, as solver drift
                    would, so the audit's alert can be drilled
  heartbeat         server/core.py Server.heartbeat -- stalls or drops a
                    client's check-in, so its node can be driven down

Actions: ``error`` raises InjectedFault; ``delay`` sleeps ``delay_s``
then continues; ``hang`` blocks until the fault is disarmed (bounded by
``delay_s`` when given, else unbounded: the watchdog deadline is what
must save the caller).

Arming: ``faults.arm(...)``, or ``NOMAD_TPU_TORCH_FAULT_INJECT`` when
the module is first imported: ``point=action[:delay_s[:count]]`` entries
separated by commas, e.g.
``NOMAD_TPU_TORCH_FAULT_INJECT="solver.dispatch=hang,solver.probe=error"``.

The unarmed path of ``fire`` is two attribute reads: the registry's
armed flag and lockcheck's (firing a point that may hang while holding
a lock is a held-across finding, armed or not).
"""
from __future__ import annotations

import logging
import os
import threading
import time
from typing import Dict, Optional

from . import lockcheck

ACTIONS = ("error", "delay", "hang")

# every ``fire(point)`` call site in the port names a member
POINTS = (
    "solver.dispatch",      # solver/guard.py run_dispatch (in the watchdog)
    "solver.probe",         # solver/guard.py _breaker_probe
    "broker.dequeue",       # server/broker.py dequeue, dequeue_batch
    "worker.invoke",        # server/worker.py invoke_scheduler
    "worker.crash",         # server/worker.py _fire_crash_point
    "plan.apply",           # server/plan_apply.py Planner.apply
    "plan.commit",          # state/store.py apply_plan_results_batch
    "quality.skew",         # server/quality.py shadow-audit capture
    "heartbeat",            # server/core.py Server.heartbeat
)

_log = logging.getLogger(__name__)


class InjectedFault(Exception):
    """Raised at an armed injection point (action=error)."""


class _Fault:
    __slots__ = ("point", "action", "delay_s", "count", "fired", "release")

    def __init__(self, point: str, action: str, delay_s: float,
                 count: Optional[int]):
        self.point = point
        self.action = action
        self.delay_s = delay_s
        self.count = count          # remaining injections; None = unlimited
        self.fired = 0
        self.release = threading.Event()    # set on disarm: wakes hangs

    def snapshot(self) -> dict:
        return {"point": self.point, "action": self.action,
                "delay_s": self.delay_s, "count": self.count,
                "fired": self.fired}


class FaultRegistry:
    """Process-global registry of armed faults, keyed by point name."""

    def __init__(self):
        self._lock = threading.Lock()
        self._faults: Dict[str, _Fault] = {}
        self._armed = False          # lock-free fast-path gate
        self._arm_from_env()

    def _arm_from_env(self) -> None:
        spec = os.environ.get("NOMAD_TPU_TORCH_FAULT_INJECT", "").strip()
        for entry in spec.split(","):
            entry = entry.strip()
            if not entry or "=" not in entry:
                continue
            point, _, rhs = entry.partition("=")
            parts = rhs.split(":")
            try:
                delay = float(parts[1]) if len(parts) > 1 and parts[1] \
                    else 0.0
                count = (int(parts[2])
                         if len(parts) > 2 and parts[2] else None)
                self.arm(point.strip(), parts[0] or "error", delay_s=delay,
                         count=count)
            except ValueError:
                continue            # a typo'd entry must not abort start-up

    def arm(self, point: str, action: str = "error", delay_s: float = 0.0,
            count: Optional[int] = None) -> dict:
        if action not in ACTIONS:
            raise ValueError(f"unknown fault action {action!r} "
                             f"(one of {ACTIONS})")
        if not point:
            raise ValueError("fault point name required")
        f = _Fault(point, action, float(delay_s),
                   int(count) if count is not None else None)
        with self._lock:
            old = self._faults.get(point)
            if old is not None:
                old.release.set()
            self._faults[point] = f
            self._armed = True
        _log.warning("armed %s=%s delay=%s count=%s", point, action,
                     delay_s, count)
        return f.snapshot()

    def disarm(self, point: str) -> bool:
        with self._lock:
            f = self._faults.pop(point, None)
            self._armed = bool(self._faults)
        if f is None:
            return False
        f.release.set()              # wake any thread hung at this point
        _log.warning("disarmed %s", point)
        return True

    def disarm_all(self) -> int:
        with self._lock:
            faults = list(self._faults.values())
            self._faults.clear()
            self._armed = False
        for f in faults:
            f.release.set()
        return len(faults)

    def snapshot(self) -> dict:
        with self._lock:
            return {"faults": [f.snapshot()
                               for f in self._faults.values()]}

    def fire(self, point: str) -> None:
        """Called at an injection point: a no-op unless the point is
        armed."""
        if lockcheck._ACTIVE:
            lockcheck.note_fire(point)
        if not self._armed:
            return
        with self._lock:
            f = self._faults.get(point)
            if f is None:
                return
            f.fired += 1
            if f.count is not None:
                f.count -= 1
                if f.count <= 0:
                    del self._faults[point]
                    self._armed = bool(self._faults)
                    f.release.set()
        if f.action == "delay":
            time.sleep(f.delay_s)
            return
        if f.action == "hang":
            # blocks until disarmed (or delay_s when bounded); callers
            # survive through their own watchdog deadline
            f.release.wait(f.delay_s if f.delay_s > 0 else None)
            return
        raise InjectedFault(f"injected fault: {point}")

    def _reset_for_tests(self) -> None:
        self.disarm_all()


# Process-global registry; ``fire`` is the hot-path entry point.
faults = FaultRegistry()
fire = faults.fire
