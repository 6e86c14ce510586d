"""Runtime lock-order sanitizer ("lockcheck") for the port's control
plane (port of nomad_tpu/lockcheck.py).

The port's barrier, dispatch pipeline, group-commit applier, resident
set, broker and telemetry take some fifty ``threading.Lock / RLock /
Condition`` sites. This checker works on the order graph, not on luck:

  * every acquire of an instrumented lock records the acquiring
    thread's held set into a global acquisition-order graph; a cycle
    (A taken while holding B somewhere, B while holding A elsewhere) is
    a potential deadlock even if it never fired. Both witness stacks
    (one per conflicting edge) are kept for the report.
  * locks held across a device dispatch (``guard.run_dispatch``:
    ``note_dispatch``), a ``faultinject.fire`` point (``note_fire``) or
    a blocking ``queue.Queue.get`` / ``Condition.wait`` longer than
    ``NOMAD_TPU_TORCH_LOCKCHECK_WAIT_MS`` are reported: a dispatch can
    burn a whole watchdog deadline, and every peer of a held lock waits
    that long too.
  * bare ``.acquire()`` calls whose frame returns (or whose thread
    exits) with the lock still held are reported as escaped acquires.

Off by default; ``NOMAD_TPU_TORCH_LOCKCHECK=0`` or unset is a true
no-op: ``threading.Lock`` and the rest are the originals and no wrapper
class is observable. ``NOMAD_TPU_TORCH_LOCKCHECK=1`` at import, or
``enable()``, patches the factories through schedcheck's interposition
seam (which refuses when another owner -- the reference package's
lockcheck, say -- has patched them); only locks constructed from files
under ``nomad_tpu_torch/`` (plus the ``roots`` given to ``enable``) are
instrumented, so stdlib and torch internals keep their raw primitives.
Locks that exist before ``enable`` stay raw. Counters:
``nomad.lockcheck.{cycle,held_across,escaped}``.

Knobs: ``NOMAD_TPU_TORCH_LOCKCHECK`` (off; ``1`` installs at import),
``NOMAD_TPU_TORCH_LOCKCHECK_WAIT_MS`` (100: blocking-wait report
threshold), ``NOMAD_TPU_TORCH_LOCKCHECK_STACK`` (16: witness stack
depth), ``NOMAD_TPU_TORCH_LOCKCHECK_MAX`` (256: kept reports per class).
"""
from __future__ import annotations

import os
import queue
import sys
import threading
import time
import traceback
from typing import Dict, List, Optional, Set, Tuple

import _thread

# the deterministic-schedule sibling (schedcheck.py): the wrappers
# below double as its lock / condvar interposition points, gated on one
# module-attr read when it is off. Its module top imports only the
# stdlib, so this import cannot cycle. It also owns the patch seam.
from . import schedcheck as _schedcheck

# the real factories: schedcheck captured them when it loaded
_REAL_LOCK = _schedcheck._PRISTINE[(threading, "Lock")][0]
_REAL_RLOCK = _schedcheck._PRISTINE[(threading, "RLock")][0]
_REAL_CONDITION = _schedcheck._PRISTINE[(threading, "Condition")][0]

_PKG_ROOT = os.path.dirname(os.path.abspath(__file__))
_REPO_ROOT = os.path.dirname(_PKG_ROOT)
_SELF = os.path.join(_PKG_ROOT, "lockcheck")

_ACTIVE = False                  # module-global fast gate (one dict read)
_roots: Tuple[str, ...] = (_PKG_ROOT,)   # instrumented source prefixes

# checker-internal state; _slock is a RAW lock and a leaf: nothing is
# ever acquired under it and no user code runs under it
_slock = _REAL_LOCK()
_EDGE_CAP = 8192
_PATH_VISIT_CAP = 10000

_wait_ms = 100.0
_stack_depth = 16
_max_reports = 256

_serial = [0]                    # next lock id (under _slock)
_sites: Dict[int, str] = {}      # lock id -> construction site
_held: Dict[int, list] = {}      # thread id -> [_Held, ...] (own thread
                                 # appends/pops; readers copy)
_adj: Dict[int, Set[int]] = {}   # order graph: lock id -> successors
_edge_wit: Dict[Tuple[int, int], dict] = {}
_cycles: List[dict] = []
_cycle_keys: Set[frozenset] = set()
_held_across: List[dict] = []
_held_across_keys: Set[tuple] = set()
_escaped: List[dict] = []
_escaped_keys: Set[tuple] = set()
_counters = {"locks": 0, "acquires": 0, "edges_dropped": 0,
             "reports_dropped": 0}


class _Held:
    __slots__ = ("lock", "depth", "bare", "frame_id", "code_name",
                 "site", "thread_name")

    def __init__(self, lock, bare, frame):
        self.lock = lock
        self.depth = 1
        self.bare = bare
        self.frame_id = id(frame) if frame is not None else 0
        self.code_name = (frame.f_code.co_name if frame is not None
                          else "?")
        self.site = (f"{_rel(frame.f_code.co_filename)}:{frame.f_lineno}"
                     if frame is not None else "?")
        self.thread_name = threading.current_thread().name


def _rel(path: str) -> str:
    if path.startswith(_REPO_ROOT):
        return path[len(_REPO_ROOT) + 1:]
    return path


def _fmt_stack(frame) -> str:
    try:
        return "".join(traceback.format_stack(frame, limit=_stack_depth))
    except Exception:  # noqa: BLE001 -- diagnostics must never raise
        return "<stack unavailable>"


def _metrics():
    """Telemetry sink, or None mid-teardown -- the sanitizer must
    never take the process down with it."""
    try:
        from .server.telemetry import metrics
        return metrics
    except Exception:  # noqa: BLE001
        return None


# ----------------------------------------------------------------------
# recording


def _held_list() -> list:
    tid = _thread.get_ident()
    lst = _held.get(tid)
    if lst is None:
        lst = _held[tid] = []    # GIL-atomic single-key insert
    return lst


def _record_acquire(w, bare: bool, frame) -> None:
    if not _ACTIVE:
        return
    lst = _held_list()
    for e in reversed(lst):
        if e.lock is w:          # RLock re-entry: no new edges
            e.depth += 1
            return
    _counters["acquires"] += 1
    new_edges = [(e.lock._lc_id, w._lc_id) for e in lst
                 if (e.lock._lc_id, w._lc_id) not in _edge_wit]
    lst.append(_Held(w, bare, frame))
    if not new_edges:
        return
    # witness stack captured OUTSIDE _slock (format_stack allocates)
    stack = _fmt_stack(frame)
    thread_name = threading.current_thread().name
    cycles_found = []
    with _slock:
        for a, b in new_edges:
            if (a, b) in _edge_wit:
                continue
            if len(_edge_wit) >= _EDGE_CAP:
                _counters["edges_dropped"] += 1
                continue
            _edge_wit[(a, b)] = {
                "from": _sites.get(a, "?"), "to": _sites.get(b, "?"),
                "thread": thread_name, "stack": stack,
            }
            _adj.setdefault(a, set()).add(b)
            # path [b, ..., a]: the wrap-around edge a->b (just added)
            # closes the cycle
            path = _find_path(b, a)
            if path is not None:
                cyc = _record_cycle_locked(path)
                if cyc is not None:
                    cycles_found.append(cyc)
    if cycles_found:
        m = _metrics()
        if m is not None:
            m.incr("nomad.lockcheck.cycle", n=len(cycles_found))


def _find_path(src: int, dst: int) -> Optional[List[int]]:
    """DFS src -> dst in the order graph (under _slock). Returns the
    node path [src, ..., dst] or None."""
    if src == dst:
        return [src]
    stack = [(src, [src])]
    seen = {src}
    visits = 0
    while stack:
        node, path = stack.pop()
        for nxt in _adj.get(node, ()):
            visits += 1
            if visits > _PATH_VISIT_CAP:
                return None
            if nxt == dst:
                return path + [dst]
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


def _record_cycle_locked(nodes: List[int]) -> Optional[dict]:
    """nodes is the cycle's node sequence [n0, ..., nk] where the edge
    nk->n0 closes the loop. Dedup by edge set; keep every edge's
    witness (both stacks of an AB/BA inversion)."""
    edges = [(nodes[i], nodes[(i + 1) % len(nodes)])
             for i in range(len(nodes))]
    key = frozenset(edges)
    if key in _cycle_keys:
        return None
    _cycle_keys.add(key)
    if len(_cycles) >= _max_reports:
        _counters["reports_dropped"] += 1
        return None
    cyc = {
        "locks": [_sites.get(n, "?") for n in nodes],
        "edges": [dict(_edge_wit.get((a, b)) or
                       {"from": _sites.get(a, "?"),
                        "to": _sites.get(b, "?"),
                        "thread": "?", "stack": "<unwitnessed>"})
                  for a, b in edges],
        # replayable counterexample: the active schedcheck run's seed
        # + decision step (None outside a controlled schedule)
        "schedule": _schedcheck.witness(),
    }
    _cycles.append(cyc)
    return cyc


def _record_release(w, full: bool = False) -> None:
    if not _ACTIVE:
        return
    lst = _held.get(_thread.get_ident())
    if not lst:
        return
    for i in range(len(lst) - 1, -1, -1):
        if lst[i].lock is w:
            if full or lst[i].depth <= 1:
                del lst[i]
            else:
                lst[i].depth -= 1
            return
    # not found: state was reset mid-critical-section, or the lock is
    # being released by a thread that never recorded the acquire
    # (cross-thread hand-off -- the acquirer's entry stays and the
    # escaped-frame check will surface it)


def _held_other(exclude=None) -> List[dict]:
    """Sites of locks the current thread holds (minus ``exclude``)."""
    lst = _held.get(_thread.get_ident())
    if not lst:
        return []
    return [{"lock": e.lock._lc_site, "acquired_at": e.site}
            for e in list(lst) if e.lock is not exclude]


def _note_held_across(kind: str, others: List[dict],
                      detail: str = "") -> None:
    key = (kind, tuple(o["lock"] for o in others))
    with _slock:
        if key in _held_across_keys:
            return
        _held_across_keys.add(key)
        if len(_held_across) >= _max_reports:
            _counters["reports_dropped"] += 1
            return
        _held_across.append({
            "kind": kind, "detail": detail, "held": others,
            "thread": threading.current_thread().name,
            "stack": _fmt_stack(sys._getframe(2)),
        })
    m = _metrics()
    if m is not None:
        m.incr("nomad.lockcheck.held_across")


# ----------------------------------------------------------------------
# hooks called from the rest of the tree (each is gated on _ACTIVE by
# the caller reading lockcheck._ACTIVE first, and re-checks here)


def note_fire(point: str) -> None:
    """faultinject.fire entry: firing a fault point -- which may hang
    or raise by design -- while holding locks turns an injected solver
    wedge into a control-plane wedge."""
    if not _ACTIVE:
        return
    others = _held_other()
    if others:
        _note_held_across(f"faultinject.fire:{point}", others)


def note_dispatch(label: str) -> None:
    """guard.run_dispatch entry: a device dispatch can burn a full
    watchdog deadline; holding any lock across it starves every other
    thread that needs that lock for the same deadline."""
    if not _ACTIVE:
        return
    others = _held_other()
    if others:
        _note_held_across(f"solver.dispatch:{label}", others)


def _held_timed_get(self, block, timeout, inner):
    """queue.Queue.get (schedcheck's combined patch calls this first):
    a blocking get that waits past the threshold while other locks are
    held is a held-across finding."""
    if _ACTIVE and block:
        others = _held_other()
        if others:
            t0 = time.monotonic()
            try:
                return inner(self, block, timeout)
            finally:
                dt_ms = (time.monotonic() - t0) * 1000.0
                if dt_ms >= _wait_ms:
                    _note_held_across("queue.get", others,
                                      f"{dt_ms:.0f}ms")
    return inner(self, block, timeout)


# ----------------------------------------------------------------------
# instrumented primitives


class _LockWrapper:
    """Instrumented Lock/RLock. Delegates to a real primitive; records
    acquire/release into the checker when it is active. Implements the
    Condition owner protocol so instrumented condvars keep the held-set
    exact across wait()."""

    def __init__(self, inner, site: str, kind: str):
        self._lc_inner = inner
        self._lc_site = site
        self._lc_kind = kind
        # the holding thread's ident (0: free): schedcheck waits for a
        # holder outside its schedule for real, keeping the floor
        self._lc_owner = 0
        with _slock:
            _serial[0] += 1
            self._lc_id = _serial[0]
            _sites[self._lc_id] = site
            _counters["locks"] += 1

    def acquire(self, blocking=True, timeout=-1):
        if blocking and _schedcheck._ACTIVE:
            _schedcheck.lock_gate(self._lc_inner, owner=self)
        ok = self._lc_inner.acquire(blocking, timeout)
        if ok:
            self._lc_owner = _thread.get_ident()
            _record_acquire(self, True, sys._getframe(1))
        return ok

    def _inner_release(self):
        # cleared before the release (a new holder sets its own), and
        # set back where an RLock is still held by this thread
        self._lc_owner = 0
        self._lc_inner.release()
        if self._lc_kind == "rlock" and self._lc_inner._is_owned():
            self._lc_owner = _thread.get_ident()

    def release(self):
        self._inner_release()
        _record_release(self)
        if _schedcheck._ACTIVE:
            _schedcheck.lock_released(self._lc_inner)

    def __enter__(self):
        if _schedcheck._ACTIVE:
            _schedcheck.lock_gate(self._lc_inner, owner=self)
        # this IS the lock: the paired release is __exit__
        self._lc_inner.acquire()
        self._lc_owner = _thread.get_ident()
        _record_acquire(self, False, sys._getframe(1))
        return self

    def __exit__(self, *exc):
        _record_release(self)
        self._inner_release()
        if _schedcheck._ACTIVE:
            _schedcheck.lock_released(self._lc_inner)
        return False

    def locked(self):
        return self._lc_inner.locked()

    # -- Condition owner protocol -------------------------------------
    def _release_save(self):
        _record_release(self, full=True)
        self._lc_owner = 0
        if self._lc_kind == "rlock":
            state = self._lc_inner._release_save()
        else:
            self._lc_inner.release()
            state = None
        if _schedcheck._ACTIVE:
            _schedcheck.lock_released(self._lc_inner)
        return state

    def _acquire_restore(self, state):
        if self._lc_kind == "rlock":
            self._lc_inner._acquire_restore(state)
        else:
            # Condition owner protocol: wait() re-acquires here and
            # releases through _release_save
            self._lc_inner.acquire()
        self._lc_owner = _thread.get_ident()
        _record_acquire(self, False, sys._getframe(1))

    def _is_owned(self):
        if self._lc_kind == "rlock":
            return self._lc_inner._is_owned()
        if self._lc_inner.acquire(False):
            self._lc_inner.release()
            return False
        return True

    def _at_fork_reinit(self):
        self._lc_inner._at_fork_reinit()

    def __repr__(self):
        return (f"<lockcheck.{self._lc_kind} {self._lc_site} "
                f"inner={self._lc_inner!r}>")


class _InstrumentedCondition(_REAL_CONDITION):
    """Real Condition over an instrumented lock; times waits so a
    thread parked on a condvar while holding OTHER locks past the
    threshold is reported.  Under an active schedcheck run, wait and
    notify route through the controller instead of the OS: the waiter
    parks virtually (no wall clock burns) and notify makes it runnable
    at the next scheduling decision -- which is what makes condvar
    handoff order a deterministic function of the schedule seed."""

    def wait(self, timeout=None):
        if _schedcheck._ACTIVE and _schedcheck.managed_active():
            state = self._release_save()
            try:
                notified = _schedcheck.cond_wait_gate(
                    id(self), timed=timeout is not None, timeout=timeout)
            finally:
                inner = getattr(self._lock, "_lc_inner", None)
                if inner is not None:
                    _schedcheck.lock_gate(inner, "cond.reacquire",
                                          owner=self._lock)
                self._acquire_restore(state)
            return notified
        if not _ACTIVE:
            return super().wait(timeout)
        others = _held_other(exclude=self._lock)
        if not others:
            return super().wait(timeout)
        t0 = time.monotonic()
        try:
            return super().wait(timeout)
        finally:
            dt_ms = (time.monotonic() - t0) * 1000.0
            if dt_ms >= _wait_ms:
                _note_held_across("condition.wait", others,
                                  f"{dt_ms:.0f}ms")

    def notify(self, n=1):
        super().notify(n)
        if _schedcheck._ACTIVE:
            _schedcheck.cond_notify(id(self), n)

    def notify_all(self):
        super().notify_all()
        if _schedcheck._ACTIVE:
            _schedcheck.cond_notify(id(self), None)


# ----------------------------------------------------------------------
# factories installed over threading.Lock/RLock/Condition while enabled


def _caller_site(depth: int = 2):
    """Construction call site as 'rel/path.py:line', or None when the
    caller is outside the instrumented roots (stdlib / torch locks stay
    raw)."""
    f = sys._getframe(depth)
    fn = f.f_code.co_filename
    if fn.startswith(_SELF) or not fn.startswith(_roots):
        return None
    return f"{_rel(fn)}:{f.f_lineno}"


def _lock_factory():
    inner = _REAL_LOCK()
    if not _ACTIVE:
        return inner
    site = _caller_site()
    if site is None:
        return inner
    return _LockWrapper(inner, site, "lock")


def _rlock_factory():
    inner = _REAL_RLOCK()
    if not _ACTIVE:
        return inner
    site = _caller_site()
    if site is None:
        return inner
    return _LockWrapper(inner, site, "rlock")


def _condition_factory(lock=None):
    if not _ACTIVE:
        return _REAL_CONDITION(lock)
    site = _caller_site()
    if site is None:
        return _REAL_CONDITION(lock)
    if lock is None:
        lock = _LockWrapper(_REAL_RLOCK(), site, "rlock")
    return _InstrumentedCondition(lock)


# ----------------------------------------------------------------------
# lifecycle


def enabled() -> bool:
    return _ACTIVE


_FACTORIES = ((threading, "Lock", _lock_factory),
              (threading, "RLock", _rlock_factory),
              (threading, "Condition", _condition_factory))


def enable(roots=()) -> None:
    """Patch the threading factories and the queue get, and start
    recording. ``roots``: more source paths (files or directories)
    whose locks are instrumented beside the package's own. Locks that
    already exist stay raw. Raises RuntimeError when another owner's
    patch is in place."""
    global _ACTIVE, _wait_ms, _stack_depth, _max_reports, _roots
    with _slock:
        if _ACTIVE:
            return
        _schedcheck.seam_check(
            "lockcheck", [(o, n) for o, n, _ in _FACTORIES]
            + [(queue.Queue, "get")])
        _wait_ms = float(os.environ.get(
            "NOMAD_TPU_TORCH_LOCKCHECK_WAIT_MS", "100"))
        _stack_depth = int(os.environ.get(
            "NOMAD_TPU_TORCH_LOCKCHECK_STACK", "16"))
        _max_reports = int(os.environ.get(
            "NOMAD_TPU_TORCH_LOCKCHECK_MAX", "256"))
        _roots = (_PKG_ROOT,) + tuple(os.path.abspath(str(r))
                                      for r in roots)
        for obj, name, fn in _FACTORIES:
            _schedcheck.seam_install("lockcheck", obj, name, fn)
        _schedcheck._LC_QUEUE_HOOK = _held_timed_get
        _schedcheck.seam_install("lockcheck", queue.Queue, "get",
                                 _schedcheck._patched_queue_get)
        _ACTIVE = True


def disable() -> None:
    """Restore the original factories. Wrappers created while enabled
    keep working (they always delegate to a real primitive) but go
    inert."""
    global _ACTIVE
    if not _ACTIVE:
        return
    _ACTIVE = False
    _schedcheck._LC_QUEUE_HOOK = None
    for obj, name, _ in _FACTORIES:
        _schedcheck.seam_release("lockcheck", obj, name)
    _schedcheck.seam_release("lockcheck", queue.Queue, "get",
                             _schedcheck._patched_queue_get)


def maybe_install_from_env() -> None:
    if os.environ.get("NOMAD_TPU_TORCH_LOCKCHECK", "0") == "1":
        enable()


# ----------------------------------------------------------------------
# reporting


def _check_escapes() -> None:
    """A bare .acquire() whose acquiring frame is no longer on its
    thread's stack (or whose thread exited) while the lock is still
    held: the release, if it ever comes, is someone else's problem."""
    frames = sys._current_frames()
    alive = {t.ident for t in threading.enumerate()}
    found = []
    for tid, lst in list(_held.items()):
        for e in list(lst):
            if not e.bare:
                continue
            reason = None
            if tid not in alive:
                reason = "thread-exited"
            else:
                f = frames.get(tid)
                on_stack = False
                while f is not None:
                    if id(f) == e.frame_id and \
                            f.f_code.co_name == e.code_name:
                        on_stack = True
                        break
                    f = f.f_back
                if not on_stack:
                    reason = "frame-exited"
            if reason is None:
                continue
            key = (e.lock._lc_id, e.frame_id)
            with _slock:
                if key in _escaped_keys:
                    continue
                _escaped_keys.add(key)
                if len(_escaped) >= _max_reports:
                    _counters["reports_dropped"] += 1
                    continue
                _escaped.append({
                    "lock": e.lock._lc_site, "acquired_at": e.site,
                    "in_function": e.code_name, "reason": reason,
                    "thread": e.thread_name,
                })
                found.append(key)
    if found:
        m = _metrics()
        if m is not None:
            m.incr("nomad.lockcheck.escaped", n=len(found))


def state() -> dict:
    """Full checker state (capped)."""
    if _ACTIVE:
        _check_escapes()
    with _slock:
        return {
            "enabled": _ACTIVE,
            "wait_ms": _wait_ms,
            "locks": _counters["locks"],
            "acquires": _counters["acquires"],
            "edges": len(_edge_wit),
            "edges_dropped": _counters["edges_dropped"],
            "reports_dropped": _counters["reports_dropped"],
            "cycle_count": len(_cycles),
            "cycles": [dict(c) for c in _cycles],
            "held_across": [dict(v) for v in _held_across],
            "escaped": [dict(v) for v in _escaped],
        }


def _reset_for_tests() -> None:
    with _slock:
        _held.clear()
        _adj.clear()
        _edge_wit.clear()
        _cycles.clear()
        _cycle_keys.clear()
        _held_across.clear()
        _held_across_keys.clear()
        _escaped.clear()
        _escaped_keys.clear()
        for k in _counters:
            _counters[k] = 0
