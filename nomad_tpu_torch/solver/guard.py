"""Dispatch guard: never let a wedged card stall scheduling (port of
nomad_tpu/solver/guard.py).

A broken driver or a lost card can hang CUDA initialisation, or a
launch, for ever: not fail, hang. An eval thread that walks into it
never returns, and evals pin at pending. Two layers guard against that.

INIT GUARD -- ``backend_available()`` probes CUDA once per process
(``torch.cuda.device_count()`` in a daemon thread under
``NOMAD_TPU_TORCH_BACKEND_TIMEOUT``). A timed-out probe pins the answer
False: the stranded thread cannot be cancelled, and a later CUDA call
would hang its caller the same way. ``reprobe()`` re-checks through the
late thread's flag and a killable subprocess probe. A ``cpu`` cell has
no transport that can wedge: for it the in-process answer is final and
no probe runs.

DISPATCH BREAKER -- a passing init says nothing about the card staying
healthy, so every dispatch runs under a watchdog deadline
(``run_dispatch``, ``NOMAD_TPU_TORCH_DISPATCH_TIMEOUT``). A timeout or
an exception surfaces as ``DispatchFailed`` and feeds a circuit breaker:
``NOMAD_TPU_TORCH_BREAKER_THRESHOLD`` consecutive failures trip it open;
a background thread then probes with exponential backoff
(``NOMAD_TPU_TORCH_BREAKER_BACKOFF`` .. ``_BACKOFF_MAX``; each probe a
subprocess that imports torch, loads the port's kernel library and
launches one kernel, bounded by ``NOMAD_TPU_TORCH_BREAKER_PROBE_TIMEOUT``,
else ``NOMAD_TPU_TORCH_REPROBE_TIMEOUT``) and closes it when a probe
passes. Both edges drop the resident buffer set and the stack arena.

The guard answers; it picks no device, and nothing here turns a failed
CUDA dispatch into a CPU or plain-version result. Only an eval bound for
the CPU may go to the host stack when its dispatch is refused or fails
(``host_fallback_allowed``); for a card, ``DispatchFailed`` reaches the
scheduler's caller. Counters (dispatch ok / timeout / error, host
fallbacks per eval, host-stack places under a tpu-* algorithm, trips and
recoveries) are in ``state()``.
"""
from __future__ import annotations

import logging
import os
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Optional, Tuple

import torch

from .. import jitcheck, lockcheck, schedcheck
from ..faultinject import faults
from ..server.telemetry import metrics
from ..server.tracing import tracer

_log = logging.getLogger(__name__)
ROOT = Path(__file__).resolve().parents[2]

_LOCK = threading.Lock()
_STATE = {
    "checked": False,
    "ok": False,
    "probe_started_at": None,      # epoch seconds
    "probe_timeout_s": None,
    "probe_timed_out": False,
    "recovered_late": False,
    "last_reprobe": None,          # dict, see reprobe()
}
# (checked, ok) as ONE atomically replaced tuple for the lock-free fast
# path; only replaced under _LOCK (_set_flags_locked)
_FLAGS: Tuple[bool, bool] = (False, False)
_PROBE = {"done": None, "result": None}    # threading.Event / dict

_COUNT_LOCK = threading.Lock()
_COUNTS = {"dispatch_ok": 0, "dispatch_timeout": 0, "dispatch_error": 0,
           "host_fallback_dispatches": 0, "placements_host_fallback": 0,
           "backend_unavailable": 0, "backend_recovered": 0}

BREAKER_CLOSED = "closed"
BREAKER_OPEN = "open"
BREAKER_HALF_OPEN = "half_open"

_BREAKER = {
    "state": BREAKER_CLOSED,
    "consecutive_failures": 0,
    "trips": 0,
    "recoveries": 0,
    "last_trip_at": None,
    "last_failure": None,          # "timeout" | "error"
    "backoff_s": None,             # current recovery backoff
    "last_probe": None,            # {"at", "ok", "report"}
    "platform": "cuda",            # device type of the last dispatch
    "epoch": 0,                    # bumped on reset: stale threads exit
    "wake": None,                  # current recovery thread's Event
}


# the counts the metrics registry also carries, as nomad.solver.<name>
# (placements_host_fallback is the scheduler's series: scheduler/generic.py)
_SOLVER_SERIES = frozenset(("dispatch_ok", "dispatch_timeout",
                            "dispatch_error", "host_fallback_dispatches",
                            "backend_unavailable", "backend_recovered"))


def _count(name: str, n: int = 1) -> None:
    with _COUNT_LOCK:
        _COUNTS[name] += n
    if name in _SOLVER_SERIES:
        metrics.incr("nomad.solver." + name, n)


def _device_type(device) -> str:
    """The platform of a device or of a list of cells (their first)."""
    if isinstance(device, (list, tuple)):
        device = device[0] if device else None
    return torch.device("cuda" if device is None else device).type


def _set_flags_locked(checked: bool, ok: bool) -> None:
    global _FLAGS
    _STATE["checked"] = checked
    _STATE["ok"] = ok
    _FLAGS = (checked, ok)


def _count_devices() -> int:
    """The in-process init probe's question."""
    return int(torch.cuda.device_count()) if torch.cuda.is_available() \
        else 0


def backend_available(timeout_s: float = 0.0, device=None) -> bool:
    """Can dispatches reach ``device`` (default: the CUDA cards)? A ``cpu``
    device always can. For CUDA the first call probes init once, in a
    daemon thread bounded by ``timeout_s`` (else
    NOMAD_TPU_TORCH_BACKEND_TIMEOUT, 30 s), and the answer is pinned.
    Advisory: the dispatch watchdog is the hard bound."""
    if _device_type(device) == "cpu":
        return True
    checked, ok = _FLAGS
    if checked and ok:
        return True
    with _LOCK:
        if _STATE["checked"]:
            if not _STATE["ok"]:
                _maybe_recover_locked()
            return _STATE["ok"]
        timeout = timeout_s or float(
            os.environ.get("NOMAD_TPU_TORCH_BACKEND_TIMEOUT", "30"))
        done = threading.Event()
        result = {"n": 0}
        _PROBE["done"] = done
        _PROBE["result"] = result

        def probe() -> None:
            try:
                result["n"] = _count_devices()
            except Exception:  # noqa: BLE001 -- any failure = no backend
                result["n"] = 0
            finally:
                done.set()

        t = threading.Thread(target=probe, daemon=True,
                             name="solver-backend-probe")
        _STATE["probe_started_at"] = time.time()
        _STATE["probe_timeout_s"] = timeout
        t.start()
        # the probe deadline is real time: a schedcheck run must not
        # expire it virtually, or a healthy card reads as down
        with schedcheck.real_time():
            ok = done.wait(timeout) and result["n"] > 0
        _set_flags_locked(True, ok)
        _STATE["probe_timed_out"] = not done.is_set()
    if not ok:
        _count("backend_unavailable")
        _log.error("CUDA backend unavailable (init did not report a card "
                   "within %.0f s)", timeout)
    return ok


def cards_seen() -> int:
    """The card count the init probe reported, 0 before it ran or when
    it found none. A flag read: it never touches CUDA itself."""
    checked, ok = _FLAGS
    result = _PROBE["result"]
    if not (checked and ok) or result is None:
        return 0
    return int(result["n"])


def dispatch_allowed(device=None) -> bool:
    """Should an eval dispatch to ``device`` now? False while init is
    down or the breaker is not closed (half-open included: recovery is
    probe-driven)."""
    if not backend_available(device=device):
        return False
    return _BREAKER["state"] == BREAKER_CLOSED


def note_host_fallback() -> None:
    """Record one eval that went to the host oracle because the guard
    or the breaker is down (a silent fallback must still be counted),
    and pin the fallback on the eval's trace."""
    _count("host_fallback_dispatches")
    tracer.mark_degraded("host_fallback", breaker=_BREAKER["state"],
                         backend_ok=_STATE["ok"])


def note_host_placements(n: int = 1) -> None:
    """Record ``n`` places the host stack made under a tpu-* algorithm
    (the reference's ``nomad.scheduler.placements_host_fallback``): what
    the device path does not model, such as a sticky disk's
    reschedule."""
    _count("placements_host_fallback", n)


def host_fallback_allowed(device=None) -> bool:
    """May an eval whose dispatch to ``device`` was refused (init down,
    breaker open) or failed (``DispatchFailed``) be placed by the host
    stack? Only on the CPU. For a card the refusal or failure is raised
    to the scheduler's caller, so no kernel failure is hidden behind a
    host placement."""
    return _device_type(device) == "cpu"


def refuse_dispatch(device=None) -> None:
    """Raise DispatchFailed("refused") for an eval bound for ``device``
    that may not dispatch now (the caller has checked
    dispatch_allowed): on a card the eval fails rather than go to the
    host stack."""
    b = breaker_state()
    raise DispatchFailed(
        "refused", f"dispatch to {_device_type(device)} refused: init "
        f"{'ok' if _STATE['ok'] else 'down'}, breaker {b['state']}")


# ----------------------------------------------------------------------
# Deadline-bounded dispatch


class DispatchFailed(RuntimeError):
    """One device dispatch timed out or raised."""

    def __init__(self, kind: str, msg: str):
        super().__init__(msg)
        self.kind = kind            # "timeout" | "error" | "refused"


def dispatch_deadline_s() -> float:
    """Watchdog deadline per dispatch (NOMAD_TPU_TORCH_DISPATCH_TIMEOUT,
    30 s); <= 0 runs the dispatch inline, still breaker-accounted."""
    return float(os.environ.get("NOMAD_TPU_TORCH_DISPATCH_TIMEOUT", "30"))


def run_dispatch(fn, label: str = "solver.dispatch",
                 timeout_s: Optional[float] = None, device=None):
    """Run ONE dispatch under the watchdog deadline.

    ``fn`` runs on a daemon thread that first enters ``device`` (its
    cell: a thread starts on CUDA device 0) and fires the
    ``solver.dispatch`` fault point. If it neither returns nor raises
    within the deadline, the caller gets DispatchFailed("timeout") at
    once; the stranded thread runs on (a hung launch cannot be
    cancelled), but the caller survives. An exception comes back as
    DispatchFailed("error") with the exception as its cause. Outcomes
    feed the breaker: failures count toward a trip, a success resets
    the count."""
    if lockcheck._ACTIVE:
        # a dispatch can burn a whole deadline: a lock held across it
        # starves every peer of that lock as long
        lockcheck.note_dispatch(label)
    if schedcheck._ACTIVE:
        # dispatch entry is a schedule decision point
        schedcheck.yield_point("guard.run_dispatch")
    timeout = dispatch_deadline_s() if timeout_s is None else timeout_s
    dev = torch.device("cuda" if device is None else device)
    _BREAKER["platform"] = dev.type
    box: dict = {}
    done = threading.Event()
    # the runner is a fresh thread: the caller's eval (or group) trace
    # ctx travels with it, or every span under the watchdog is lost
    trace_ctx = tracer.current()
    eval_tag = ",".join(tracer.current_ids()) or "-"

    def runner() -> None:
        # jitcheck's hot region: host syncs until fn returns are
        # hot-path syncs (one module-attr read when off)
        hot = jitcheck._ACTIVE
        if hot:
            jitcheck.note_dispatch_begin(label, dev)
        try:
            with tracer.activate(trace_ctx):
                if dev.type == "cuda" and dev.index is not None:
                    with torch.cuda.device(dev):
                        faults.fire("solver.dispatch")
                        box["result"] = fn()
                else:
                    faults.fire("solver.dispatch")
                    box["result"] = fn()
        except BaseException as e:  # noqa: BLE001 -- reported to caller
            box["error"] = e
        finally:
            if hot:
                jitcheck.note_dispatch_end()
            done.set()

    if timeout <= 0:
        runner()
    else:
        threading.Thread(target=runner, daemon=True,
                         name=f"dispatch-{label}").start()
        # the watchdog deadline is real time: a virtual expiry under a
        # schedcheck run would fail a healthy card dispatch
        with schedcheck.real_time():
            expired = not done.wait(timeout)
        if expired:
            _count("dispatch_timeout")
            record_dispatch_failure("timeout")
            tracer.mark_degraded("watchdog_timeout", ctx=trace_ctx,
                                 label=label, deadline_s=timeout)
            _log.error("eval=%s %s exceeded its %.1f s deadline (dispatch "
                       "thread abandoned)", eval_tag, label, timeout)
            raise DispatchFailed(
                "timeout", f"{label} exceeded {timeout:.1f}s deadline")
    if "error" in box:
        _count("dispatch_error")
        record_dispatch_failure("error")
        err = box["error"]
        tracer.mark_degraded("dispatch_error", ctx=trace_ctx, label=label,
                             error=type(err).__name__)
        _log.error("eval=%s %s failed (%s: %s)", eval_tag, label,
                   type(err).__name__, err)
        raise DispatchFailed(
            "error", f"{label} failed: {type(err).__name__}: {err}"
        ) from err
    _count("dispatch_ok")
    record_dispatch_success()
    return box["result"]


# ----------------------------------------------------------------------
# Circuit breaker


def _invalidate_pack_layer(reason: str) -> None:
    """Drop the resident buffer set, the stack arena's pooled buffers and
    the pack caches' node matrices on a breaker edge: nothing that
    crossed a failed transport is trusted past it, and the host tables
    are derived afresh. Looked up through sys.modules, so the guard
    imports none of those modules."""
    rs = sys.modules.get("nomad_tpu_torch.solver.resident")
    if rs is not None:
        rs.invalidate_all(reason)
    tp = sys.modules.get("nomad_tpu_torch.tensor.pack")
    if tp is not None:
        tp.invalidate_pack_caches(reason)
    bt = sys.modules.get("nomad_tpu_torch.solver.batch")
    if bt is not None:
        bt.arena_clear(reason)


def _breaker_threshold() -> int:
    return max(1, int(os.environ.get(
        "NOMAD_TPU_TORCH_BREAKER_THRESHOLD", "3")))


def record_dispatch_failure(kind: str) -> None:
    """One dispatch timed out or raised. Trips the breaker at the
    threshold of consecutive failures and starts the recovery loop."""
    with _LOCK:
        _BREAKER["consecutive_failures"] += 1
        _BREAKER["last_failure"] = kind
        if (_BREAKER["state"] == BREAKER_CLOSED
                and _BREAKER["consecutive_failures"]
                >= _breaker_threshold()):
            _trip_locked(kind)


def record_dispatch_success() -> None:
    with _LOCK:
        _BREAKER["consecutive_failures"] = 0
        # a real dispatch landed: the flap-damping backoff can relax
        _BREAKER["backoff_s"] = None


def _trip_locked(kind: str) -> None:
    _BREAKER["state"] = BREAKER_OPEN
    _BREAKER["trips"] += 1
    _BREAKER["last_trip_at"] = time.time()
    epoch = _BREAKER["epoch"]
    wake = threading.Event()       # fresh per thread: a stale set() from
    _BREAKER["wake"] = wake        # an earlier reset must not skip a wait
    metrics.incr("nomad.solver.breaker_trips")
    _invalidate_pack_layer("breaker trip")
    # every eval in flight is degraded, not just the dispatch that
    # tripped the breaker: stamp every active trace
    tracer.broadcast_event("breaker.trip",
                           degraded_reason="breaker_open", kind=kind)
    _log.error("dispatch breaker OPEN after %d consecutive %ss; recovery "
               "probing starts", _BREAKER["consecutive_failures"], kind)
    threading.Thread(target=_run_recovery, args=(epoch, wake), daemon=True,
                     name="solver-breaker-recovery").start()


def _run_recovery(epoch: int, wake: threading.Event) -> None:
    """Background half-open loop: exponential backoff between probes;
    the first passing probe closes the breaker."""
    initial = float(os.environ.get("NOMAD_TPU_TORCH_BREAKER_BACKOFF",
                                   "1.0"))
    mx = float(os.environ.get("NOMAD_TPU_TORCH_BREAKER_BACKOFF_MAX",
                              "60.0"))
    with _LOCK:
        # persist backoff across flaps: probe pass -> dispatch fail ->
        # re-trip resumes where it left off
        backoff = _BREAKER["backoff_s"] or initial
        _BREAKER["backoff_s"] = backoff
    while True:
        wake.wait(backoff)
        wake.clear()
        with _LOCK:
            if (_BREAKER["epoch"] != epoch
                    or _BREAKER["state"] == BREAKER_CLOSED):
                return
            _BREAKER["state"] = BREAKER_HALF_OPEN
        ok, report = _breaker_probe()
        with _LOCK:
            if (_BREAKER["epoch"] != epoch
                    or _BREAKER["state"] == BREAKER_CLOSED):
                return
            _BREAKER["last_probe"] = {"at": time.time(), "ok": ok,
                                      "report": report}
            if ok:
                _close_breaker_locked("recovery probe passed")
                return
            _BREAKER["state"] = BREAKER_OPEN
            backoff = min(backoff * 2.0, mx)
            _BREAKER["backoff_s"] = backoff


def _close_breaker_locked(why: str) -> None:
    _BREAKER["state"] = BREAKER_CLOSED
    _BREAKER["consecutive_failures"] = 0
    _BREAKER["recoveries"] += 1
    metrics.incr("nomad.solver.breaker_recoveries")
    # buffers uploaded before the recovery are not trusted across it
    _invalidate_pack_layer("breaker recovery")
    _log.warning("dispatch breaker CLOSED (%s)", why)


def _breaker_probe() -> Tuple[bool, dict]:
    """Is the platform healthy enough to close the breaker? In order:
      1. the ``solver.probe`` fault point (tests hold the breaker open
         through it);
      2. a ``cpu`` platform: the in-process answer is final;
      3. the CUDA init guard (a late in-process recovery included);
      4. the killable subprocess probe: a fresh process must see a card,
         load the kernel library and launch a kernel.
    """
    report: dict = {}
    try:
        faults.fire("solver.probe")
    except Exception as e:  # noqa: BLE001 -- injected faults vary
        return False, {"fault_injected": f"{type(e).__name__}: {e}"}
    if _BREAKER["platform"] == "cpu":
        report["cpu_backend"] = True
        return True, report
    with _LOCK:
        recovered = _maybe_recover_locked()
        in_ok = _STATE["checked"] and _STATE["ok"]
    report["in_process_ok"] = bool(in_ok or recovered)
    if not (in_ok or recovered):
        return False, report
    timeout = float(os.environ.get(
        "NOMAD_TPU_TORCH_BREAKER_PROBE_TIMEOUT",
        os.environ.get("NOMAD_TPU_TORCH_REPROBE_TIMEOUT", "60")))
    sub = _subprocess_probe(timeout)
    report["subprocess"] = sub
    return (not sub["timed_out"] and sub["devices"] > 0), report


def reset_breaker() -> None:
    """Close the breaker and end any recovery thread (operator reprobe,
    tests)."""
    with _LOCK:
        _BREAKER["epoch"] += 1
        if _BREAKER["state"] != BREAKER_CLOSED:
            _close_breaker_locked("operator reset")
        _BREAKER["consecutive_failures"] = 0
        _BREAKER["backoff_s"] = None
        wake = _BREAKER["wake"]
    if wake is not None:
        wake.set()               # a stale recovery thread exits promptly


_BREAKER_KEYS = ("state", "consecutive_failures", "trips", "recoveries",
                 "last_trip_at", "last_failure", "backoff_s", "last_probe",
                 "platform")


def breaker_state() -> dict:
    with _LOCK:
        return {k: _BREAKER[k] for k in _BREAKER_KEYS}


# ----------------------------------------------------------------------
# Init-guard recovery: late-thread flag + subprocess probe


def _maybe_recover_locked() -> bool:
    """If the first probe thread finished late with a card, CUDA is
    usable from this process: flip the guard back. True on recovery."""
    done, result = _PROBE["done"], _PROBE["result"]
    if (done is not None and done.is_set()
            and result and result["n"] > 0 and not _STATE["ok"]):
        _set_flags_locked(True, True)
        _STATE["recovered_late"] = True
        _count("backend_recovered")
        _log.warning("CUDA backend recovered (late probe completion)")
        return True
    return False


def _launch_check() -> None:
    """What the subprocess probe runs on a machine with a card: build or
    load the kernel library, launch the delta scatter at the launch-floor
    shape (16 elements, 8 updates) and hold it against its plain
    version; raise if it differs."""
    from . import resident
    dev = torch.device("cuda", 0)
    buf = torch.arange(16, dtype=torch.float32)
    idx = torch.tensor([0, 3, 5, 7, 9, 11, 13, 15], dtype=torch.int32)
    vals = torch.full((8,), -1.5, dtype=torch.float32)
    got = resident.delta_scatter(buf.to(dev), idx.to(dev), vals.to(dev))
    want = resident.delta_scatter_plain(buf, idx, vals)
    if not torch.equal(got.cpu(), want):
        raise RuntimeError("delta_scatter differs from its plain version")


# argv[1]: the repository root
_SUBPROBE_SRC = (
    "import sys\n"
    "sys.path.insert(0, sys.argv[1])\n"
    "import torch\n"
    "n = torch.cuda.device_count() if torch.cuda.is_available() else 0\n"
    "if n:\n"
    "    from nomad_tpu_torch.solver import guard\n"
    "    guard._launch_check()\n"
    "print('N:%d' % n)\n"
)


def _subprocess_probe(timeout_s: float) -> dict:
    """Probe the card from a THROWAWAY process: its own session, output
    to a temp file, the whole process group killed at the deadline (a
    hung driver call can leave helpers holding pipe ends, so pipes and
    communicate() could block past the timeout)."""
    import signal
    import tempfile

    with tempfile.TemporaryFile() as out:
        proc = subprocess.Popen(
            [sys.executable, "-c", _SUBPROBE_SRC, str(ROOT)],
            stdout=out, stderr=subprocess.DEVNULL, start_new_session=True)
        try:
            rc = proc.wait(timeout=timeout_s)
            timed_out = False
        except subprocess.TimeoutExpired:
            rc = None
            timed_out = True
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except OSError:
                pass
            proc.wait()     # reap; killpg makes this immediate
        out.seek(0)
        text = out.read().decode(errors="replace")
    n = 0
    if not timed_out and rc == 0:
        for line in text.splitlines():
            if line.startswith("N:"):
                n = int(line[2:])
    return {"timed_out": timed_out, "rc": rc, "devices": n}


def reprobe(timeout_s: Optional[float] = None) -> dict:
    """Recovery check on request. Never hangs the caller: the
    in-process check is a flag read, the transport check a killable
    subprocess. A recovery here also resets the breaker."""
    timeout = timeout_s or float(
        os.environ.get("NOMAD_TPU_TORCH_REPROBE_TIMEOUT", "60"))
    with _LOCK:
        checked = _STATE["checked"]
    if not checked:
        # never consulted: the answer is the normal in-process timed
        # probe (adopting a subprocess verdict would let a thread walk
        # into an unguarded first CUDA init)
        ok = backend_available(timeout_s=min(timeout, 30.0))
        report = {"recovered": False, "subprocess": None,
                  "tunnel_ok_process_wedged": False,
                  "first_probe_ok": ok}
        with _LOCK:
            _STATE["last_reprobe"] = {"at": time.time(),
                                      "report": dict(report)}
        report["state"] = state()
        return report
    with _LOCK:
        recovered = _maybe_recover_locked()
    report = {"recovered": recovered, "subprocess": None,
              "tunnel_ok_process_wedged": False}
    if not recovered:
        sub = _subprocess_probe(timeout)
        report["subprocess"] = sub
        with _LOCK:
            report["tunnel_ok_process_wedged"] = (
                sub["devices"] > 0 and not _STATE["ok"]
                and _STATE["probe_timed_out"])
    if recovered:
        reset_breaker()
    with _LOCK:
        _STATE["last_reprobe"] = {"at": time.time(),
                                  "report": dict(report)}
    report["state"] = state()
    return report


def state() -> dict:
    """The guard's snapshot: init flags, breaker, dispatch counters, the
    dispatch pipeline, the resident set, the pack caches, the stack
    arena, the pack's time and memo counts, and the mesh route
    (``service.mesh_status``). ``degraded``
    is True whenever init is down or the breaker is not closed."""
    from ..tensor.pack import pack_cache_stats
    from . import batch, resident, service
    with _LOCK:
        snap = {k: _STATE[k] for k in
                ("checked", "ok", "probe_started_at", "probe_timeout_s",
                 "probe_timed_out", "recovered_late", "last_reprobe")}
        breaker = {k: _BREAKER[k] for k in _BREAKER_KEYS}
    with _COUNT_LOCK:
        counts = dict(_COUNTS)
    snap["backend_unavailable_total"] = counts["backend_unavailable"]
    snap["host_fallback_dispatches"] = counts["host_fallback_dispatches"]
    snap["placements_host_fallback"] = counts["placements_host_fallback"]
    snap["recovered_total"] = counts["backend_recovered"]
    snap["breaker"] = breaker
    msnap = metrics.snapshot()
    series = msnap.get("counters", {})
    snap["dispatch"] = {"ok": counts["dispatch_ok"],
                        "timeout": counts["dispatch_timeout"],
                        "error": counts["dispatch_error"]}
    snap["resident"] = resident.stats()
    snap["dispatch_pipeline"] = batch.pipeline_state()
    snap["pack_cache"] = pack_cache_stats()
    snap["pack_arena"] = batch.arena_state()
    snap["pack"] = {
        "ms": msnap.get("samples", {}).get("nomad.solver.pack_ms", {}),
        "cache_hit": series.get("nomad.solver.pack_cache_hit", 0),
        "cache_miss": series.get("nomad.solver.pack_cache_miss", 0),
    }
    snap["mesh"] = service.mesh_status()
    snap["degraded"] = bool(
        (snap["checked"] and not snap["ok"])
        or breaker["state"] != BREAKER_CLOSED)
    return snap


def _reset_for_tests() -> None:
    with _LOCK:
        _set_flags_locked(False, False)
        _STATE.update(probe_started_at=None,
                      probe_timeout_s=None, probe_timed_out=False,
                      recovered_late=False, last_reprobe=None)
        _PROBE["done"] = None
        _PROBE["result"] = None
        _BREAKER["epoch"] += 1
        wake = _BREAKER["wake"]
        _BREAKER.update(state=BREAKER_CLOSED, consecutive_failures=0,
                        trips=0, recoveries=0, last_trip_at=None,
                        last_failure=None, backoff_s=None,
                        last_probe=None, platform="cuda", wake=None)
    with _COUNT_LOCK:
        for k in _COUNTS:
            _COUNTS[k] = 0
    if wake is not None:
        wake.set()
