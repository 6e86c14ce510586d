"""Snapshot-isolation and state-aliasing sanitizer ("statecheck") for
the port's store (port of nomad_tpu/statecheck.py).

The port's server runs many eval threads over snapshots of one
StateStore, a group-commit applier and memos keyed by table versions.
This checker names violations of the store's discipline:

  * **torn reads** -- the AllocTable reads (the scheduler's ``pack``,
    ``count_placed`` and ``usage_by_node``; ``fold_verify`` and
    ``_fold_verify_all``, the applier's verify fold) re-check the table
    ``version`` on exit: a version that moved during one read means a
    writer raced a reader without the store lock. Per-thread scopes
    group reads: the applier's verify (``Planner._evaluate_plan``) opens
    a STRICT scope, in which two versions are a torn read with both
    sites; the worker's eval scope (``worker.invoke_scheduler``) is not
    strict -- the packer may read usage newer than the eval's snapshot
    by design, since the applier re-verifies -- so drift there is kept
    as report-only ``drift``.
  * **aliasing writes** -- (1) published memo arrays (what
    tensor/pack.py freezes, and the resident set's frozen chain
    shadows) register through ``note_published``, and a rotating
    re-fingerprint catches a thawed flag or changed content; (2) the
    fold views ``_fold_verify_all`` hands out register against the
    table version, so content that changes under a standing version
    means a consumer wrote into the store's fold; (3) table mutators
    must bump ``version`` (version-blind mutation), and a sample of
    written rows is re-hashed (row bytes changed under a standing
    version).
  * **journal gaps** -- an ``allocs`` bump with ``delta=None`` outside
    ``with statecheck.mark_uncoverable(reason):`` (the designed
    wholesale write, ``StateStore.replace_allocs``) is a span
    ``alloc_deltas_since`` cannot cover. Report-only.
  * **write skew** -- two plan results in ONE
    ``apply_plan_results_batch`` that touch the same node: the
    applier's grouping keeps a batch disjoint, so an overlap means two
    same-snapshot plans skipped it. Report-only.
  * **stale memos** -- ``_NODE_MATRIX_CACHE`` and resident content
    entries tagged older than the newest node-table write they were
    told of, and memo hits (``note_memo_served``: the node matrix, the
    usage base, the table fold) whose version token differs from the
    snapshot's.

Off by default; ``NOMAD_TPU_TORCH_STATECHECK=0`` or unset is a true
no-op: the AllocTable and StateStore methods are the originals and no
wrapper is observable. ``NOMAD_TPU_TORCH_STATECHECK=1`` at import, or
``enable()``, installs the patches. Counters:
``nomad.statecheck.{torn_read,aliasing_write,journal_gap,write_skew,
stale_memo}``.

Knobs: ``NOMAD_TPU_TORCH_STATECHECK`` (off; ``1`` installs at import),
``NOMAD_TPU_TORCH_STATECHECK_STACK`` (16: witness stack depth),
``NOMAD_TPU_TORCH_STATECHECK_MAX`` (256: kept reports per class),
``NOMAD_TPU_TORCH_STATECHECK_REHASH`` (32: registered rows and arrays
re-hashed per ``state()`` read).
"""
from __future__ import annotations

import hashlib
import os
import sys
import threading
import traceback
from collections import OrderedDict
from typing import Dict, List, Optional

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SELF_FILE = os.path.abspath(__file__).rstrip("co")  # .pyc -> .py

_ACTIVE = False                  # module-global fast gate (one dict read)
_REAL: dict = {}                 # originals, captured at first enable

# checker-internal state; _slock is a leaf: nothing is acquired under
# it and no user code runs under it
_slock = threading.Lock()

_stack_depth = 16
_max_reports = 256
_rehash_n = 32

# report lists + dedup keys, one pair per detector class
_torn: List[dict] = []
_torn_keys: set = set()
_aliasing: List[dict] = []
_aliasing_keys: set = set()
_gaps: List[dict] = []
_gap_keys: set = set()
_skews: List[dict] = []
_skew_keys: set = set()
_stale: List[dict] = []
_stale_keys: set = set()
_drifts: List[dict] = []         # report-only: designed optimistic reads
_drift_keys: set = set()

# published-array registry: id(arr) -> (arr, digest, site). numpy
# arrays are not weakref-able, so strong refs under a FIFO byte budget
# (the jitcheck trade: an opt-in sanitizer pins a bounded sample).
_published: "OrderedDict[int, tuple]" = OrderedDict()
_PUB_CAP = 1024
_PUB_MAX_BYTES = 64 * 1024 * 1024
_pub_bytes = [0]
_pub_cursor = [0]
# fold-view registry: id(arr) -> (arr, table, version, digest, site)
_fold_views: "OrderedDict[int, tuple]" = OrderedDict()
_FOLD_CAP = 64
# sampled row registry: (id(table), row) -> (table, digest, version)
_rows: "OrderedDict[tuple, tuple]" = OrderedDict()
_ROWS_CAP = 512
_row_cursor = [0]
_ROWS_PER_WRITE = 4              # rows fingerprinted per mutator call

# the newest node-table index each cache layer was told to invalidate
# to (fed by the patched _bump); the stale-memo sweep compares
# version-tagged entries against it
_latest_nodes_index = [0]

_counters = {"reads": 0, "mutations": 0, "scopes": 0, "journal_writes": 0,
             "uncoverable_marked": 0, "batch_commits": 0,
             "memo_serves": 0, "reports_dropped": 0}

_tls = threading.local()


def _scopes() -> list:
    st = getattr(_tls, "scopes", None)
    if st is None:
        st = _tls.scopes = []
    return st


def _uncoverable_depth() -> int:
    return getattr(_tls, "uncoverable", 0)


def _rel(path: str) -> str:
    if path.startswith(_REPO_ROOT):
        return path[len(_REPO_ROOT) + 1:]
    return path


def _metrics():
    """Telemetry sink, or None mid-teardown -- the sanitizer must
    never take the process down with it."""
    try:
        from .server.telemetry import metrics
        return metrics
    except Exception:  # noqa: BLE001
        return None


def _span_ids() -> str:
    """The enclosing tracing span's eval ids, or '-'."""
    try:
        from .server.tracing import tracer
        return ",".join(tracer.current_ids()) or "-"
    except Exception:  # noqa: BLE001
        return "-"


def _repo_site() -> str:
    """First repo frame outside this module, as 'rel/path.py:line'."""
    f = sys._getframe(2)
    for _ in range(24):
        if f is None:
            return "?"
        fn = f.f_code.co_filename
        if fn.startswith(_REPO_ROOT) and \
                os.path.abspath(fn) != _SELF_FILE:
            return f"{_rel(fn)}:{f.f_lineno}"
        f = f.f_back
    return "?"


def _fmt_stack() -> str:
    try:
        return "".join(traceback.format_stack(
            sys._getframe(2), limit=_stack_depth))
    except Exception:  # noqa: BLE001 -- diagnostics must never raise
        return "<stack unavailable>"


def _digest(arr) -> bytes:
    import numpy as np
    h = hashlib.blake2b(digest_size=16)
    h.update(str((arr.dtype.str, arr.shape)).encode())
    h.update(np.ascontiguousarray(arr).data)
    return h.digest()


def _report(lst: List[dict], keys: set, key, payload: dict) -> bool:
    """Dedup + cap + record one finding; returns True when it is new.
    Callers emit their own counter with a literal series name (the
    metrics-doc checker reads emit sites, and one finding = one
    increment of its class counter).  Findings recorded during an
    active schedcheck run carry its schedule witness (seed + policy +
    decision step): ``schedcheck.replay`` re-runs the interleaving that
    manifested them."""
    from . import schedcheck
    payload.setdefault("schedule", schedcheck.witness())
    with _slock:
        if key in keys:
            return False
        keys.add(key)
        if len(lst) >= _max_reports:
            _counters["reports_dropped"] += 1
            return False
        lst.append(payload)
    return True


def _incr_metric_torn() -> None:
    m = _metrics()
    if m is not None:
        m.incr("nomad.statecheck.torn_read")


# ----------------------------------------------------------------------
# snapshot scopes (torn reads + drift)


class _Scope:
    __slots__ = ("tag", "strict", "obs", "span", "baseline")

    def __init__(self, tag: str, strict: bool, baseline):
        self.tag = tag
        self.strict = strict
        # id(table) -> (version, site) of the first observation; the
        # baseline (the eval snapshot's table version at scope open)
        # seeds it so drift against the *snapshot* is visible even when
        # the scope performs a single read
        self.obs: Dict[int, tuple] = {}
        self.span = _span_ids()
        self.baseline = baseline


class _NullScope:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SCOPE = _NullScope()


class _ScopeCM:
    __slots__ = ("_scope",)

    def __init__(self, scope: _Scope):
        self._scope = scope

    def __enter__(self):
        _scopes().append(self._scope)
        _counters["scopes"] += 1
        return self

    def __exit__(self, *exc):
        st = _scopes()
        if st and st[-1] is self._scope:
            st.pop()
        return False


def eval_scope(snapshot=None):
    """Per-eval snapshot scope (worker.invoke_scheduler): reads during
    the scope are attributed to it; version drift against the eval's
    snapshot is recorded report-only (the fast packing path observes
    newer usage BY DESIGN -- the applier re-verifies)."""
    if not _ACTIVE:
        return _NULL_SCOPE
    baseline = None
    if snapshot is not None:
        table = getattr(snapshot, "alloc_table", None)
        if table is not None:
            baseline = (id(table), table.version)
    return _ScopeCM(_Scope("eval", False, baseline))


def strict_scope(tag: str):
    """A scope whose reads MUST observe one table version (the plan
    applier's verification: fold + python walk against one state).
    Two versions inside a strict scope is a torn read."""
    if not _ACTIVE:
        return _NULL_SCOPE
    return _ScopeCM(_Scope(tag, True, None))


def _note_scope_read(op: str, table, version: int) -> None:
    st = _scopes()
    if not st:
        return
    scope = st[-1]
    prev = scope.obs.get(id(table))
    if prev is not None and prev[0] == version:
        return                    # steady state: no frame walk paid
    site = _repo_site()
    if prev is None:
        if scope.baseline is not None and scope.baseline[0] == id(table) \
                and scope.baseline[1] != version:
            _note_drift(scope, op, site, scope.baseline[1], version)
        scope.obs[id(table)] = (version, site)
        return
    if scope.strict:
        if _report(
                _torn, _torn_keys, ("scope", scope.tag, op, site),
                {"kind": "scope-tear", "scope": scope.tag, "op": op,
                 "site": site, "first_site": prev[1],
                 "versions": [prev[0], version], "evals": scope.span,
                 "thread": threading.current_thread().name,
                 "stack": _fmt_stack()}):
            _incr_metric_torn()
    else:
        _note_drift(scope, op, site, prev[0], version)
    scope.obs[id(table)] = (version, site)


def _note_drift(scope: _Scope, op: str, site: str, v0: int,
                v1: int) -> None:
    _report(
        _drifts, _drift_keys, (scope.tag, op, site),
        {"scope": scope.tag, "op": op, "site": site,
         "versions": [v0, v1], "evals": scope.span,
         "thread": threading.current_thread().name})


# ----------------------------------------------------------------------
# AllocTable read instrumentation (torn reads)


def _mk_read(name: str, real):
    def wrapper(self, *a, **k):
        if not _ACTIVE:
            return real(self, *a, **k)
        _counters["reads"] += 1
        v0 = self.version
        try:
            return real(self, *a, **k)
        finally:
            v1 = self.version
            if v1 != v0:
                if _report(
                        _torn, _torn_keys,
                        ("intra", name, _repo_site()),
                        {"kind": "intra-read-tear", "op": name,
                         "site": _repo_site(),
                         "versions": [v0, v1], "evals": _span_ids(),
                         "thread": threading.current_thread().name,
                         "stack": _fmt_stack()}):
                    _incr_metric_torn()
            _note_scope_read(name, self, v1)

    wrapper.__name__ = name
    wrapper._statecheck_wrapped = True
    return wrapper


def _fold_verify_all_wrapper(self):
    """_fold_verify_all hands out VIEWS of the live incremental fold
    columns on the delta path -- register their content against the
    table version so a consumer writing into them (they cannot be
    frozen: the table itself maintains them in place under the store
    lock) is caught by the audit."""
    real = _REAL["table._fold_verify_all"]
    if not _ACTIVE:
        return real(self)
    _counters["reads"] += 1
    v0 = self.version
    try:
        out = real(self)
        with _slock:
            already = any(v[1] is self and v[2] == self.version
                          for v in _fold_views.values())
        if not already:
            # one registration per (table, version): steady-state
            # verifies re-serve the same views and pay nothing
            site = _repo_site()
            with _slock:
                for arr in out:
                    if getattr(arr, "nbytes", 0) == 0:
                        continue
                    _fold_views[id(arr)] = (arr, self, self.version,
                                            _digest(arr), site)
                while len(_fold_views) > _FOLD_CAP:
                    _fold_views.popitem(last=False)
        return out
    finally:
        v1 = self.version
        if v1 != v0:
            if _report(
                    _torn, _torn_keys,
                    ("intra", "_fold_verify_all", _repo_site()),
                    {"kind": "intra-read-tear",
                     "op": "_fold_verify_all",
                     "site": _repo_site(), "versions": [v0, v1],
                     "evals": _span_ids(),
                     "thread": threading.current_thread().name,
                     "stack": _fmt_stack()}):
                _incr_metric_torn()
        _note_scope_read("_fold_verify_all", self, v1)


# ----------------------------------------------------------------------
# AllocTable mutator instrumentation (aliasing writes)


def _note_aliasing(kind: str, site: str, detail: str) -> None:
    if _report(
            _aliasing, _aliasing_keys, (kind, site),
            {"kind": kind, "site": site, "detail": detail,
             "thread": threading.current_thread().name,
             "stack": _fmt_stack()}):
        m = _metrics()
        if m is not None:
            m.incr("nomad.statecheck.aliasing_write")


def _row_digest(table, row: int) -> bytes:
    h = hashlib.blake2b(digest_size=16)
    for col in ("node_slot", "cpu", "mem", "disk", "live",
                "live_strict", "special", "job_hash", "jobtg_hash"):
        h.update(bytes(getattr(table, col)[row:row + 1].data))
    h.update(bytes(table.ports[row].data))
    return h.digest()


def _register_rows(table, rows) -> None:
    with _slock:
        for row in rows[:_ROWS_PER_WRITE]:
            _rows[(id(table), int(row))] = (
                table, _row_digest(table, int(row)), table.version)
        while len(_rows) > _ROWS_CAP:
            _rows.popitem(last=False)


def _mk_mutator(name: str, real, must_bump):
    """``must_bump(self, args) -> bool``: whether this call is required
    to advance ``version`` (an empty upsert_many or a remove() of an
    unknown id legitimately leaves it alone). The real method is read
    from _REAL at call time so tests can stub a buggy mutator under
    the wrapper."""
    key = f"table.{name}"

    def wrapper(self, *a, **k):
        real = _REAL[key]
        if not _ACTIVE:
            return real(self, *a, **k)
        _counters["mutations"] += 1
        v0 = self.version
        # kwargs-only calls (nothing in the repo does this) skip the
        # must-bump judgment rather than index a missing positional
        required = must_bump(self, a) if a or name == "register_node" \
            else False
        try:
            return real(self, *a, **k)
        finally:
            if required and self.version == v0:
                _note_aliasing(
                    "version-blind-mutation", _repo_site(),
                    f"AllocTable.{name} mutated rows without bumping "
                    f"version (every version-keyed cache above is now "
                    f"silently stale)")
            elif a and self.version != v0 and \
                    name in ("upsert", "upsert_many"):
                allocs = a[0] if name == "upsert_many" else [a[0]]
                rows = [self._row_of[al.id] for al in
                        list(allocs)[:_ROWS_PER_WRITE]
                        if al.id in self._row_of]
                _register_rows(self, rows)

    wrapper.__name__ = name
    wrapper._statecheck_wrapped = True
    return wrapper


# ----------------------------------------------------------------------
# published memo arrays (aliasing writes, jitcheck-style registry)


def note_published(arr, site: Optional[str] = None) -> None:
    """An array became reachable from a published snapshot or a
    version-keyed memo (tensor/pack freezes and the resident set's
    chain shadows route here): it must be
    ``writeable=False`` and its content must never change again."""
    if not _ACTIVE:
        return
    if getattr(arr, "nbytes", None) is None:
        return
    site = site or _repo_site()
    writable_now = bool(getattr(arr, "flags", None) is not None
                        and arr.flags.writeable)
    nbytes = int(arr.nbytes)
    with _slock:
        if id(arr) not in _published:
            _pub_bytes[0] += nbytes
        _published[id(arr)] = (arr, _digest(arr), site)
        while _published and (len(_published) > _PUB_CAP
                              or _pub_bytes[0] > _PUB_MAX_BYTES):
            _, (old, _d, _s) = _published.popitem(last=False)
            _pub_bytes[0] -= int(getattr(old, "nbytes", 0))
    if writable_now:
        _note_aliasing("published-writeable", site,
                       "array published to a snapshot/memo without "
                       "writeable=False")


def note_memo_served(kind: str, entry_version, live_version,
                     site: Optional[str] = None) -> None:
    """A version-keyed memo hit: the served entry's version token must
    match the version the caller's snapshot pins (hit paths that skip
    their catch-up/refold on a mismatched token serve stale state)."""
    if not _ACTIVE:
        return
    _counters["memo_serves"] += 1
    if entry_version is None or live_version is None:
        return
    if entry_version == live_version:
        return
    site = site or _repo_site()
    if _report(
            _stale, _stale_keys, (kind, site),
            {"kind": kind, "site": site,
             "entry_version": int(entry_version),
             "live_version": int(live_version), "evals": _span_ids(),
             "thread": threading.current_thread().name,
             "stack": _fmt_stack()}):
        m = _metrics()
        if m is not None:
            m.incr("nomad.statecheck.stale_memo")


# ----------------------------------------------------------------------
# delta-journal coverage (gaps) + write-skew + stale-memo feeds
# (StateStore patches)


class _Uncoverable:
    __slots__ = ("reason", "_entered")

    def __init__(self, reason: str):
        self.reason = reason
        self._entered = False

    def __enter__(self):
        if _ACTIVE:
            self._entered = True
            _tls.uncoverable = _uncoverable_depth() + 1
            _counters["uncoverable_marked"] += 1
        return self

    def __exit__(self, *exc):
        if self._entered:
            _tls.uncoverable = max(0, _uncoverable_depth() - 1)
        return False


def mark_uncoverable(reason: str) -> _Uncoverable:
    """Marks a write that REPLACES alloc state wholesale
    (``StateStore.replace_allocs``, the snapshot-restore form): its
    delta-less journal entry is an explicit gap, not a silent one, so
    the checker stays quiet about it."""
    return _Uncoverable(reason)


def _patched_bump(self, *tables, delta=None):
    if _ACTIVE:
        if "allocs" in tables:
            _counters["journal_writes"] += 1
            if delta is None and _uncoverable_depth() == 0:
                site = _repo_site()
                if _report(
                        _gaps, _gap_keys, site,
                        {"site": site, "tables": list(tables),
                         "evals": _span_ids(),
                         "thread": threading.current_thread().name,
                         "stack": _fmt_stack()}):
                    m = _metrics()
                    if m is not None:
                        m.incr("nomad.statecheck.journal_gap")
    idx = _REAL["store._bump"](self, *tables, delta=delta)
    if _ACTIVE and "nodes" in tables:
        ni = self._table_index.get("nodes", 0)
        with _slock:
            if ni > _latest_nodes_index[0]:
                _latest_nodes_index[0] = ni
    return idx


def _patched_apply_batch(self, entries):
    if _ACTIVE and len(entries) > 1:
        _counters["batch_commits"] += 1
        seen: Dict[str, str] = {}
        for result, _evs in entries:
            label = "?"
            for nid in list(result.node_allocation) + \
                    list(result.node_update):
                allocs = (result.node_allocation.get(nid)
                          or result.node_update.get(nid) or [])
                if allocs:
                    label = allocs[0].eval_id or "?"
                first = seen.get(nid)
                if first is not None and first != label:
                    if _report(
                            _skews, _skew_keys, (nid, first, label),
                            {"node": nid, "plans": [first, label],
                             "evals": _span_ids(),
                             "thread": threading.current_thread().name,
                             "stack": _fmt_stack()}):
                        m = _metrics()
                        if m is not None:
                            m.incr("nomad.statecheck.write_skew")
                elif first is None:
                    seen[nid] = label
    return _REAL["store.apply_batch"](self, entries)


# ----------------------------------------------------------------------
# audit pass (rotating samples; runs on every state() read)


def verify_state(sample: Optional[int] = None) -> int:
    """Re-check the registries: published-array freeze + content, live
    fold views, sampled row fingerprints, and the version-tagged cache
    sweeps. Returns the number of NEW findings."""
    if not _ACTIVE:
        return 0
    n = sample if sample is not None else _rehash_n
    found = 0
    with _slock:
        pub = list(_published.items())
        cursor = _pub_cursor[0]
        views = list(_fold_views.items())
        rows = list(_rows.items())
        row_cursor = _row_cursor[0]
    # published memo arrays: thawed flag or content drift
    for i in range(min(n, len(pub))):
        key, (arr, digest, site) = pub[(cursor + i) % len(pub)]
        if getattr(arr, "flags", None) is not None \
                and arr.flags.writeable:
            if _note_aliasing_ret("published-thawed", site,
                                  "published memo array became "
                                  "writeable again"):
                found += 1
            continue
        try:
            fresh = _digest(arr)
        except Exception:  # noqa: BLE001 -- resized/retyped arrays
            fresh = b"?"
        if fresh != digest:
            if _note_aliasing_ret(
                    "published-mutated", site,
                    f"published memo array content changed after "
                    f"registration (dtype={arr.dtype}, "
                    f"shape={arr.shape})"):
                found += 1
            with _slock:
                if key in _published:
                    _published[key] = (arr, fresh, site)
    if pub:
        with _slock:
            _pub_cursor[0] = (cursor + n) % max(len(_published), 1)
    # live fold views: content drift under an unchanged table version
    for key, (arr, table, version, digest, site) in views:
        if table.version != version:
            with _slock:
                _fold_views.pop(key, None)
            continue
        try:
            fresh = _digest(arr)
        except Exception:  # noqa: BLE001
            fresh = b"?"
        if fresh != digest:
            if _note_aliasing_ret(
                    "fold-view-mutated", site,
                    "a consumer wrote into the store's resident fold "
                    "columns (handed out as read views by "
                    "_fold_verify_all)"):
                found += 1
            with _slock:
                _fold_views.pop(key, None)
    # sampled rows: bytes changed under an unchanged version
    for i in range(min(n, len(rows))):
        key, (table, digest, version) = rows[(row_cursor + i)
                                             % len(rows)]
        if table.version != version:
            with _slock:
                _rows.pop(key, None)
            continue
        try:
            fresh = _row_digest(table, key[1])
        except Exception:  # noqa: BLE001 -- compacted/shrunk tables
            with _slock:
                _rows.pop(key, None)
            continue
        if fresh != digest:
            if _note_aliasing_ret(
                    "row-mutated", f"row {key[1]}",
                    "alloc-table row bytes changed without a version "
                    "bump (direct column write bypassing the "
                    "instrumented mutators)"):
                found += 1
            with _slock:
                _rows.pop(key, None)
    if rows:
        with _slock:
            _row_cursor[0] = (row_cursor + n) % max(len(_rows), 1)
    found += _sweep_version_tagged_caches()
    return found


def _note_aliasing_ret(kind: str, site: str, detail: str) -> bool:
    before = len(_aliasing)
    _note_aliasing(kind, site, detail)
    return len(_aliasing) > before


def _sweep_version_tagged_caches() -> int:
    """Entries tagged with a node-table version older than the latest
    write their cache was notified of should have been dropped by that
    notification; survivors are stale memos."""
    latest = _latest_nodes_index[0]
    if not latest:
        return 0
    found = 0
    sweeps = []
    tpack = sys.modules.get("nomad_tpu_torch.tensor.pack")
    if tpack is not None:
        with tpack._NODE_MATRIX_LOCK:
            sweeps += [("node_matrix", "tensor/pack.py", k[0])
                       for k in tpack._NODE_MATRIX_CACHE if k[0] < latest]
    rs = sys.modules.get("nomad_tpu_torch.solver.resident")
    if rs is not None:
        with rs._LOCK:
            sweeps += [("resident", "solver/resident.py", ent.version)
                       for ent in rs._CACHE.values()
                       if ent.version is not None and ent.version < latest]
    for kind, site, v in sweeps:
        if _report(
                _stale, _stale_keys, (kind, v),
                {"kind": kind, "site": site, "entry_version": int(v),
                 "live_version": int(latest), "evals": "-",
                 "thread": threading.current_thread().name,
                 "stack": "<audit sweep>"}):
            found += 1
            m = _metrics()
            if m is not None:
                m.incr("nomad.statecheck.stale_memo")
    return found


# ----------------------------------------------------------------------
# lifecycle


def enabled() -> bool:
    return _ACTIVE


_TABLE_READS = ("pack", "fold_verify", "count_placed", "usage_by_node")
_MUTATORS = ("upsert", "upsert_many", "remove", "register_node", "compact")


def enable() -> None:
    """Patch the AllocTable reads and mutators and the StateStore
    journal and batch-commit entry points. Arrays and rows published
    before enable are invisible until registered again."""
    global _ACTIVE, _stack_depth, _max_reports, _rehash_n
    with _slock:
        if _ACTIVE:
            return
        _stack_depth = int(os.environ.get(
            "NOMAD_TPU_TORCH_STATECHECK_STACK", "16"))
        _max_reports = int(os.environ.get(
            "NOMAD_TPU_TORCH_STATECHECK_MAX", "256"))
        _rehash_n = max(1, int(os.environ.get(
            "NOMAD_TPU_TORCH_STATECHECK_REHASH", "32")))
    from .state.alloc_table import AllocTable
    from .state.store import StateStore
    if not _REAL:
        for name in _TABLE_READS + _MUTATORS + ("_fold_verify_all",):
            _REAL[f"table.{name}"] = getattr(AllocTable, name)
        _REAL["store._bump"] = StateStore._bump
        _REAL["store.apply_batch"] = StateStore.apply_plan_results_batch
    for name in _TABLE_READS:
        setattr(AllocTable, name,
                _mk_read(name, _REAL[f"table.{name}"]))
    AllocTable._fold_verify_all = _fold_verify_all_wrapper
    AllocTable.upsert = _mk_mutator(
        "upsert", _REAL["table.upsert"], lambda t, a: True)
    AllocTable.upsert_many = _mk_mutator(
        "upsert_many", _REAL["table.upsert_many"],
        lambda t, a: bool(len(a[0])))
    AllocTable.remove = _mk_mutator(
        "remove", _REAL["table.remove"],
        lambda t, a: a[0] in t._row_of)
    AllocTable.register_node = _mk_mutator(
        "register_node", _REAL["table.register_node"],
        lambda t, a: True)
    AllocTable.compact = _mk_mutator(
        "compact", _REAL["table.compact"], lambda t, a: True)
    StateStore._bump = _patched_bump
    StateStore.apply_plan_results_batch = _patched_apply_batch
    _ACTIVE = True


def disable() -> None:
    """Restore the original methods. Scopes opened while enabled drain
    naturally (their context managers go inert)."""
    global _ACTIVE
    if not _ACTIVE:
        return
    _ACTIVE = False
    from .state.alloc_table import AllocTable
    from .state.store import StateStore
    for name in _TABLE_READS + _MUTATORS + ("_fold_verify_all",):
        setattr(AllocTable, name, _REAL[f"table.{name}"])
    StateStore._bump = _REAL["store._bump"]
    StateStore.apply_plan_results_batch = _REAL["store.apply_batch"]


def maybe_install_from_env() -> None:
    if os.environ.get("NOMAD_TPU_TORCH_STATECHECK", "0") == "1":
        enable()


# ----------------------------------------------------------------------
# reporting


def state() -> dict:
    """Full checker state (capped)."""
    if _ACTIVE:
        verify_state()
    with _slock:
        return {
            "enabled": _ACTIVE,
            "reads": _counters["reads"],
            "mutations": _counters["mutations"],
            "scopes": _counters["scopes"],
            "journal_writes": _counters["journal_writes"],
            "uncoverable_marked": _counters["uncoverable_marked"],
            "batch_commits": _counters["batch_commits"],
            "memo_serves": _counters["memo_serves"],
            "published_arrays": len(_published),
            "registered_rows": len(_rows),
            "reports_dropped": _counters["reports_dropped"],
            "torn_read_count": len(_torn),
            "aliasing_write_count": len(_aliasing),
            "journal_gap_count": len(_gaps),
            "write_skew_count": len(_skews),
            "stale_memo_count": len(_stale),
            "drift_count": len(_drifts),
            "torn_reads": [dict(r) for r in _torn],
            "aliasing_writes": [dict(r) for r in _aliasing],
            "journal_gaps": [dict(r) for r in _gaps],
            "write_skews": [dict(r) for r in _skews],
            "stale_memos": [dict(r) for r in _stale],
            "drifts": [dict(r) for r in _drifts],
        }


def _reset_for_tests() -> None:
    with _slock:
        _torn.clear()
        _torn_keys.clear()
        _aliasing.clear()
        _aliasing_keys.clear()
        _gaps.clear()
        _gap_keys.clear()
        _skews.clear()
        _skew_keys.clear()
        _stale.clear()
        _stale_keys.clear()
        _drifts.clear()
        _drift_keys.clear()
        _published.clear()
        _fold_views.clear()
        _rows.clear()
        _pub_bytes[0] = 0
        _pub_cursor[0] = 0
        _row_cursor[0] = 0
        _latest_nodes_index[0] = 0
        for k in _counters:
            _counters[k] = 0
