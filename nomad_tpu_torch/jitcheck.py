"""Device-dispatch discipline sanitizer ("jitcheck") for the port's
solver (port of nomad_tpu/jitcheck.py).

The port's bet is the reference's: the inner loop runs on the card,
and a dispatch reads its results back once. This checker turns "the
card path got slow" into a named report. The port has no ``jax.jit``;
each reference check maps onto the port as follows.

  * **hot host syncs** (fail a test) -- ``guard.run_dispatch`` marks
    its runner as a hot region (``note_dispatch_begin`` / ``_end``).
    While armed, the explicit fetch forms on ``torch.Tensor`` --
    ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``, ``.to()``
    onto the CPU, ``int()``, ``float()``, ``bool()`` and ``__index__``
    -- are patched: a call on a value of the dispatch's device, inside
    the hot region and outside a ``with jitcheck.sanctioned_fetch(tag):``
    block, is a violation, attributed to the enclosing tracing span and
    its site. A CPU dispatch's device is the CPU, so the CPU tests catch
    these forms too (``.to()`` excepted there: onto a CPU cell's own
    device it is the form of an upload). The plain PyTorch version of a
    kernel (marked ``@plain_version``) stands in for the kernel on a CPU
    cell: what it does inside is the device's own work, not a host
    sync. On CUDA the
    hot regions also switch ``torch.cuda.set_sync_debug_mode("warn")``
    on (counted across threads: on at the first region, off after the
    last), which names the syncs hidden inside torch ops (boolean
    indexing, ``nonzero``, pageable copies); a ``warnings.showwarning``
    hook attributes each warning to the thread that raised it through
    that thread's hot and sanctioned flags, and an ``always`` filter
    keeps Python from hiding the second sync at one site. A kernel
    launched through ctypes is invisible to torch's check: a sync inside
    a ``.cu`` launcher would not be caught (the sources have none; a
    test keeps it so).
  * **steady-state rebuilds** (fail a test) -- the port's counterpart
    of a retrace is the same signature built twice at one site:
    ``kernels.build()`` compiling or ``kernels.load()`` loading after
    the process's first launch, a ``Kernel`` binding a dtype's entry
    point it has bound before (outside ``bind()``'s A/B use), and the
    stack arena allocating a stack for a bucket whose free list holds
    one. A NEW signature at a site that has gone steady is a
    ``late_build``, report-only (a new bucket arrives as a fleet grows).
    Launch signatures (dtype, every tensor argument's shape, the int
    arguments) are counted per kernel for the site table; a cluster
    kernel's launcher queries the occupancy and sets its attributes on
    every launch (``host_setup_repeats``, report-only); the other
    launchers export no count of their host setup, and the table says
    so.
  * **dtype drift** (report-only) -- a float64 tensor in a float32
    ``Kernel.launch``, or float64 arrays beside float32 ones in one
    ``resident.device_put_cached`` tree. The reference's weak-typed
    Python scalar has no counterpart in a ctypes launch (ints are
    marshalled as C ints), so that class is left out.
  * **cache mutation** (fail a test) -- fingerprinted sources
    (``note_fingerprint``: the resident set's content keys and its
    promotion shadows) and frozen memos (``note_frozen``: the pack
    memos, the arena's released stacks) are re-checked by a sampled
    re-hash in ``verify_caches()``.

Off by default; ``NOMAD_TPU_TORCH_JITCHECK=0`` or unset is a true
no-op: the ``torch.Tensor`` methods and ``warnings.showwarning`` are the
originals and no wrapper is observable. ``NOMAD_TPU_TORCH_JITCHECK=1`` at
import, or ``enable()``, installs the patches. Counters:
``nomad.jitcheck.{rebuild,host_sync,x64_leak,mutated_cache}``.

Knobs: ``NOMAD_TPU_TORCH_JITCHECK`` (off; ``1`` installs at import),
``NOMAD_TPU_TORCH_JITCHECK_STACK`` (16: witness stack depth),
``NOMAD_TPU_TORCH_JITCHECK_MAX`` (256: kept reports per class),
``NOMAD_TPU_TORCH_JITCHECK_REHASH`` (32: fingerprinted arrays re-hashed
per ``state()`` read).
"""
from __future__ import annotations

import functools
import hashlib
import os
import sys
import threading
import traceback
import warnings
from collections import OrderedDict
from typing import Dict, List, Optional

from . import schedcheck as _seam

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SELF_FILE = os.path.abspath(__file__).rstrip("co")  # .pyc -> .py

_ACTIVE = False                  # module-global fast gate (one dict read)

# checker-internal state; _slock is a leaf: nothing is acquired under
# it and no user code runs under it
_slock = _seam._REAL_LOCK()

_stack_depth = 16
_max_reports = 256
_rehash_n = 32

_SIG_CAP = 512                   # distinct signatures kept per site
_SYNC_MSG = "called a synchronizing CUDA operation"

# site -> {"launches", "builds", "steady", "sigs": {sig: count},
#          "host_setup": None | {sig: launches}}
_sites: "OrderedDict[str, dict]" = OrderedDict()
_rebuilds: List[dict] = []
_rebuild_keys: Dict[tuple, dict] = {}
_late_builds: List[dict] = []
_late_keys: set = set()
_host_syncs: List[dict] = []
_host_sync_keys: Dict[tuple, dict] = {}
_dtype_drift: List[dict] = []
_dtype_keys: set = set()
_mutations: List[dict] = []
_mutation_keys: set = set()
# id(arr) -> (arr, digest, site). numpy arrays are not weakref-able,
# so the registries hold strong refs under a byte budget (FIFO): an
# opt-in sanitizer pinning a bounded sample is the price of re-hashing.
_fps: "OrderedDict[int, tuple]" = OrderedDict()
_frozen: "OrderedDict[int, tuple]" = OrderedDict()
_FPS_CAP = 1024
_FPS_MAX_BYTES = 64 * 1024 * 1024
_fps_bytes = [0, 0]              # [fingerprint bytes, frozen bytes]
_rehash_cursor = [0]
_counters = {"launches": 0, "builds": 0, "rebuilds": 0, "host_syncs": 0,
             "sanctioned_fetches": 0, "x64_leaks": 0, "mutations": 0,
             "cuda_sync_warnings": 0, "reports_dropped": 0,
             "sigs_dropped": 0}
_sanct_tags: Dict[str, int] = {}
_launched = [False]              # any kernel launched in this process
# CUDA hot regions open across threads, and the sync debug mode to
# restore when the last closes
_cuda_hot = [0, 0]

_tls = threading.local()
_REAL: dict = {}                 # patched originals, for the wrappers


def _tls_state():
    st = getattr(_tls, "st", None)
    if st is None:
        st = _tls.st = {"hot": 0, "sanct": 0, "sanct_tag": "", "label": "",
                        "device": None, "plain": 0, "explicit": 0}
    return st


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
    """The enclosing tracing span's eval ids (host-sync attribution),
    or '-' outside any traced context."""
    try:
        from .server.tracing import tracer
        return ",".join(tracer.current_ids()) or "-"
    except Exception:  # noqa: BLE001
        return "-"


def _repo_site() -> Optional[str]:
    """First repo frame outside this module, as 'rel/path.py:line'."""
    f = sys._getframe(2)
    for _ in range(24):
        if f is None:
            return None
        fn = f.f_code.co_filename
        if fn.startswith(_REPO_ROOT) and os.path.abspath(fn) != _SELF_FILE:
            return f"{_rel(fn)}:{f.f_lineno}"
        f = f.f_back
    return None


def _fmt_stack() -> str:
    try:
        return "".join(traceback.format_stack(sys._getframe(2),
                                              limit=_stack_depth))
    except Exception:  # noqa: BLE001 -- diagnostics must never raise
        return "<stack unavailable>"


def _add_report(lst: list, rep: dict) -> bool:
    """Append under _slock unless the class is full."""
    if len(lst) >= _max_reports:
        _counters["reports_dropped"] += 1
        return False
    lst.append(rep)
    return True


# ----------------------------------------------------------------------
# builds, launches and signatures


def _site_rec(site: str, host_setup: bool = False) -> dict:
    rec = _sites.get(site)
    if rec is None:
        rec = _sites[site] = {"launches": 0, "builds": 0, "steady": False,
                              "sigs": {},
                              "host_setup": {} if host_setup else None}
    return rec


def note_build(site: str, sig, held: bool) -> None:
    """One build at ``site`` (a library load, an entry-point bind, an
    arena stack): ``held`` says the site already holds a build of
    ``sig`` that it should have served -- a steady-state rebuild. A new
    signature at a site that has gone steady is a late build."""
    if not _ACTIVE:
        return
    rebuild = False
    with _slock:
        rec = _site_rec(site)
        rec["builds"] += 1
        _counters["builds"] += 1
        known = sig in rec["sigs"]
        if not known and len(rec["sigs"]) >= _SIG_CAP:
            _counters["sigs_dropped"] += 1
        else:
            rec["sigs"][sig] = rec["sigs"].get(sig, 0) + 1
        if held:
            rebuild = True
            _counters["rebuilds"] += 1
            key = (site, repr(sig))
            rep = _rebuild_keys.get(key)
            if rep is not None:
                rep["count"] += 1
            else:
                rep = {"site": site, "signature": repr(sig), "count": 1,
                       "thread": threading.current_thread().name,
                       "stack": _fmt_stack()}
                if _add_report(_rebuilds, rep):
                    _rebuild_keys[key] = rep
        elif not known and rec["steady"]:
            key = (site, repr(sig))
            if key not in _late_keys:
                _late_keys.add(key)
                _add_report(_late_builds, {
                    "site": site, "signature": repr(sig),
                    "known_sigs": len(rec["sigs"]) - 1,
                    "thread": threading.current_thread().name})
    if rebuild:
        m = _metrics()
        if m is not None:
            m.incr("nomad.jitcheck.rebuild")


def note_served(site: str) -> None:
    """``site`` served a request from what it built: it is steady."""
    if not _ACTIVE:
        return
    with _slock:
        _site_rec(site)["steady"] = True


def launched() -> bool:
    """Whether any kernel launched in this process while armed."""
    return _launched[0]


def note_launch(name: str, dtype, tensors, ints,
                host_setup: bool = False) -> None:
    """``Kernel.launch`` of kernel ``name``: the launch signature, the
    float64-in-float32 drift check, and the host-setup repeats of a
    launcher that exports its cluster size (``host_setup``)."""
    if not _ACTIVE:
        return
    import torch
    shapes = tuple(tuple(t.shape) for t in tensors if type(t) is not int)
    sig = (str(dtype).replace("torch.", ""), shapes,
           tuple(int(v) for v in ints))
    f64 = sum(1 for t in tensors if type(t) is not int
              and t.dtype == torch.float64)
    site = f"kernel:{name}"
    with _slock:
        _launched[0] = True
        rec = _site_rec(site, host_setup)
        rec["launches"] += 1
        rec["steady"] = True
        _counters["launches"] += 1
        if sig in rec["sigs"] or len(rec["sigs"]) < _SIG_CAP:
            rec["sigs"][sig] = rec["sigs"].get(sig, 0) + 1
        else:
            _counters["sigs_dropped"] += 1
        if rec["host_setup"] is not None and sig in rec["sigs"]:
            rec["host_setup"][sig] = rec["sigs"][sig] - 1
    if f64 and dtype == torch.float32:
        _note_drift(site, f64, "launch")


def _note_drift(site: str, leaves: int, where: str) -> None:
    m = _metrics()
    with _slock:
        key = (site, where)
        if key not in _dtype_keys:
            _dtype_keys.add(key)
            _add_report(_dtype_drift, {
                "kind": "float64", "where": where, "site": site,
                "leaves": leaves,
                "thread": threading.current_thread().name})
        _counters["x64_leaks"] += 1
    if m is not None:
        m.incr("nomad.jitcheck.x64_leak")


def note_tree(arrays, where: str = "device_put") -> None:
    """A tree about to ship to the card (``resident.device_put_cached``):
    float64 arrays beside float32 ones mean a float64 table leaked into
    a float32 dispatch."""
    if not _ACTIVE:
        return
    kinds = [str(getattr(a, "dtype", "")) for a in arrays]
    f64 = kinds.count("float64")
    if f64 and "float32" in kinds:
        _note_drift(_repo_site() or "?", f64, where)


# ----------------------------------------------------------------------
# hot region + host-sync detection


def note_dispatch_begin(label: str = "", device=None) -> None:
    """guard.run_dispatch's runner entry (on the runner thread): host
    syncs until note_dispatch_end are hot-path syncs. ``device`` is the
    dispatch's device: fetches of tensors on it are the syncs."""
    import torch
    if not _ACTIVE:
        return
    st = _tls_state()
    dev = torch.device("cuda" if device is None else device)
    st["hot"] += 1
    st["label"] = label
    st["device"] = dev.type
    if dev.type == "cuda":
        with _slock:
            _cuda_hot[0] += 1
            first = _cuda_hot[0] == 1
        if first:
            _cuda_hot[1] = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
    st.setdefault("cuda_regions", []).append(dev.type == "cuda")


def note_dispatch_end() -> None:
    import torch
    if not _ACTIVE:
        return
    st = _tls_state()
    st["hot"] = max(0, st["hot"] - 1)
    regions = st.get("cuda_regions") or [False]
    if regions.pop():
        with _slock:
            _cuda_hot[0] = max(0, _cuda_hot[0] - 1)
            last = _cuda_hot[0] == 0
        if last:
            torch.cuda.set_sync_debug_mode(_cuda_hot[1])


class _SanctionedFetch:
    """Marks the designed one-fetch-per-dispatch sites: a read-back
    inside this block is the transport doing its job, not a hot-path
    sync. ``tag`` is the transfer-ledger group the site's fetch counts
    under (solver/xferobs.py)."""

    def __init__(self, tag: str = ""):
        self._tag = tag
        self._entered = False

    def __enter__(self):
        if _ACTIVE:
            self._entered = True
            st = _tls_state()
            st["sanct"] += 1
            self._prev_tag = st["sanct_tag"]
            st["sanct_tag"] = self._tag
        return self

    def __exit__(self, *exc):
        if self._entered:
            st = _tls_state()
            st["sanct"] = max(0, st["sanct"] - 1)
            st["sanct_tag"] = self._prev_tag
        return False


def sanctioned_fetch(tag: str = "") -> _SanctionedFetch:
    return _SanctionedFetch(tag)


def plain_version(fn):
    """Decorator for a kernel's plain PyTorch version: on a CPU cell it
    runs in the kernel's place, so its own conversions are the device's
    work, not host syncs of the dispatch."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if not _ACTIVE:
            return fn(*args, **kwargs)
        st = _tls_state()
        st["plain"] += 1
        try:
            return fn(*args, **kwargs)
        finally:
            st["plain"] -= 1
    return wrapper


def _note_sync(kind: str, st: dict) -> None:
    if st["sanct"] > 0:
        tag = st["sanct_tag"]
        with _slock:
            _counters["sanctioned_fetches"] += 1
            if tag:
                _sanct_tags[tag] = _sanct_tags.get(tag, 0) + 1
        return
    site = _repo_site() or "?"
    evals = _span_ids()
    with _slock:
        key = (kind, site)
        rep = _host_sync_keys.get(key)
        if rep is not None:
            rep["count"] += 1
        else:
            rep = {"kind": kind, "site": site, "count": 1,
                   "label": st["label"], "evals": evals,
                   "thread": threading.current_thread().name,
                   "stack": _fmt_stack()}
            if _add_report(_host_syncs, rep):
                _host_sync_keys[key] = rep
        _counters["host_syncs"] += 1
    m = _metrics()
    if m is not None:
        m.incr("nomad.jitcheck.host_sync")


def _cpu_target(args, kwargs) -> bool:
    """Whether a ``Tensor.to`` call moves the tensor onto the CPU."""
    import torch
    cands = list(args[:1]) + [kwargs.get("device")]
    for c in cands:
        if isinstance(c, torch.Tensor):
            return c.device.type == "cpu"
        if isinstance(c, (str, torch.device)):
            try:
                return torch.device(c).type == "cpu"
            except (RuntimeError, TypeError):
                return False
    return False


def _mk_fetch(name: str):
    orig = _REAL[name]

    def patched(self, *a, **k):
        st = getattr(_tls, "st", None)
        if (not _ACTIVE or st is None or st["hot"] <= 0 or st["plain"]
                or st["explicit"]
                or self.device.type != st["device"]
                or (name == "to" and (st["device"] == "cpu"
                                      or not _cpu_target(a, k)))):
            return orig(self, *a, **k)
        _note_sync(name, st)
        st["explicit"] += 1
        try:
            return orig(self, *a, **k)
        finally:
            st["explicit"] -= 1

    patched.__name__ = name
    patched._jitcheck_wrapped = True
    return patched


_FETCH_FORMS = ("item", "tolist", "cpu", "numpy", "to", "__int__",
                "__float__", "__bool__", "__index__")


def _showwarning(message, category, filename, lineno, file=None,
                 line=None):
    """Route the sync debug mode's warnings to the raising thread's
    flags: a sync in its hot region (outside a plain version and an
    explicit form already counted) is a host sync; any other is
    dropped. Other warnings go to the original hook."""
    if _SYNC_MSG not in str(message):
        return _REAL["showwarning"](message, category, filename, lineno,
                                    file, line)
    with _slock:
        _counters["cuda_sync_warnings"] += 1
    st = getattr(_tls, "st", None)
    if (_ACTIVE and st is not None and st["hot"] > 0 and not st["plain"]
            and not st["explicit"]):
        _note_sync("cuda_sync", st)
    return None


# ----------------------------------------------------------------------
# fingerprint-cache mutation + frozen-memo invariant


def _digest(arr) -> bytes:
    import numpy as np
    h = hashlib.blake2b(digest_size=16)
    h.update(str((arr.dtype.str, arr.shape)).encode())
    h.update(np.ascontiguousarray(arr).data)
    return h.digest()


def note_fingerprint(arr, digest: Optional[bytes] = None) -> None:
    """A host array's content fingerprint was just taken (the resident
    set's content key, a promotion shadow): register it for a sampled
    re-hash; a later mismatch means the source was written after it was
    fingerprinted."""
    if not _ACTIVE:
        return
    site = _repo_site() or "?"
    if digest is None:
        digest = _digest(arr)
    nbytes = int(getattr(arr, "nbytes", 0))
    with _slock:
        if id(arr) not in _fps:
            _fps_bytes[0] += nbytes
        _fps[id(arr)] = (arr, digest, site)
        while _fps and (len(_fps) > _FPS_CAP
                        or _fps_bytes[0] > _FPS_MAX_BYTES):
            _, (old, _d, _s) = _fps.popitem(last=False)
            _fps_bytes[0] -= int(getattr(old, "nbytes", 0))


def note_frozen(arr) -> None:
    """A host array was stored into a memo or a pool: it must be frozen
    (writeable=False) and stay so until ``note_thawed``."""
    if not _ACTIVE:
        return
    site = _repo_site() or "?"
    writable_now = bool(getattr(arr, "flags", None) is not None
                        and arr.flags.writeable)
    nbytes = int(getattr(arr, "nbytes", 0))
    with _slock:
        if id(arr) not in _frozen:
            _fps_bytes[1] += nbytes
        _frozen[id(arr)] = (arr, site)
        while _frozen and (len(_frozen) > _FPS_CAP
                           or _fps_bytes[1] > _FPS_MAX_BYTES):
            _, (old, _s) = _frozen.popitem(last=False)
            _fps_bytes[1] -= int(getattr(old, "nbytes", 0))
    if writable_now:
        _note_mutation("unfrozen-memo", site,
                       "array stored into a memo without writeable=False")


def note_thawed(arr) -> None:
    """A frozen array left its pool on purpose (an arena checkout)."""
    if not _ACTIVE:
        return
    with _slock:
        ent = _frozen.pop(id(arr), None)
        if ent is not None:
            _fps_bytes[1] -= int(getattr(ent[0], "nbytes", 0))


def _note_mutation(kind: str, site: str, detail: str) -> None:
    m = _metrics()
    with _slock:
        _counters["mutations"] += 1
        key = (kind, site)
        if key in _mutation_keys:
            return
        _mutation_keys.add(key)
        _add_report(_mutations, {
            "kind": kind, "site": site, "detail": detail,
            "thread": threading.current_thread().name})
    if m is not None:
        m.incr("nomad.jitcheck.mutated_cache")


def verify_caches(sample: Optional[int] = None) -> int:
    """Re-hash a rotating sample of registered fingerprint sources and
    re-check the frozen invariant; returns the number of NEW findings.
    ``state()`` calls it, so every read of the state audits."""
    if not _ACTIVE:
        return 0
    n = sample if sample is not None else _rehash_n
    with _slock:
        fps = list(_fps.items())
        frozen = list(_frozen.items())
        cursor = _rehash_cursor[0]
    found = 0
    if fps:
        for i in range(min(n, len(fps))):
            key, (arr, digest, site) = fps[(cursor + i) % len(fps)]
            try:
                fresh = _digest(arr)
            except Exception:  # noqa: BLE001 -- shrunk / retyped arrays
                fresh = b"?"
            if fresh != digest:
                _note_mutation(
                    "content-mutation", site,
                    f"fingerprinted array re-hash mismatch "
                    f"(dtype={arr.dtype}, shape={arr.shape})")
                found += 1
                with _slock:
                    # re-arm with the current content: one mutation is
                    # one finding, not one per state() read
                    if key in _fps:
                        _fps[key] = (arr, fresh, site)
        with _slock:
            _rehash_cursor[0] = (cursor + n) % max(len(_fps), 1)
    for key, (arr, site) in frozen:
        if getattr(arr, "flags", None) is not None and arr.flags.writeable:
            _note_mutation("thawed-memo", site,
                           "memoized array became writeable again")
            found += 1
            with _slock:
                _frozen.pop(key, None)
    return found


# ----------------------------------------------------------------------
# lifecycle


def enabled() -> bool:
    return _ACTIVE


def _patch_keys():
    import torch
    return ([(torch.Tensor, n) for n in _FETCH_FORMS]
            + [(warnings, "showwarning")])


def enable() -> None:
    """Patch the Tensor fetch forms and the warnings hook (refused when
    another owner's patch is on them) and start recording."""
    import torch
    global _ACTIVE, _stack_depth, _max_reports, _rehash_n
    with _slock:
        if _ACTIVE:
            return
        _seam.seam_check("jitcheck", _patch_keys())
        _stack_depth = int(os.environ.get(
            "NOMAD_TPU_TORCH_JITCHECK_STACK", "16"))
        _max_reports = int(os.environ.get(
            "NOMAD_TPU_TORCH_JITCHECK_MAX", "256"))
        _rehash_n = max(1, int(os.environ.get(
            "NOMAD_TPU_TORCH_JITCHECK_REHASH", "32")))
        for obj, name in _patch_keys():
            _REAL[name] = _seam._PRISTINE[(obj, name)][0]
        for name in _FETCH_FORMS:
            _seam.seam_install("jitcheck", torch.Tensor, name,
                               _mk_fetch(name))
        _seam.seam_install("jitcheck", warnings, "showwarning",
                           _showwarning)
        # the sync debug mode's warnings must all reach the hook: the
        # default action shows one per call site
        warnings.filterwarnings("always", message=_SYNC_MSG)
        _REAL["filter"] = warnings.filters[0]
        _ACTIVE = True


def disable() -> None:
    """Restore the originals."""
    import torch
    global _ACTIVE
    if not _ACTIVE:
        return
    _ACTIVE = False
    for obj, name in _patch_keys():
        _seam.seam_release("jitcheck", obj, name)
    flt = _REAL.pop("filter", None)
    if flt is not None:
        try:
            warnings.filters.remove(flt)
            warnings._filters_mutated()
        except (ValueError, AttributeError):
            pass
    with _slock:
        open_regions = _cuda_hot[0]
        _cuda_hot[0] = 0
    if open_regions:
        torch.cuda.set_sync_debug_mode(_cuda_hot[1])


def maybe_install_from_env() -> None:
    if os.environ.get("NOMAD_TPU_TORCH_JITCHECK", "0") == "1":
        enable()


# ----------------------------------------------------------------------
# reporting


def state(sites: bool = False) -> dict:
    """Full checker state (capped). ``sites=True`` adds the per-site
    table: launches, signatures, builds and, for the kernels, host-setup
    repeats per signature (None where the launcher exports no count)."""
    if _ACTIVE:
        verify_caches()
    with _slock:
        out = {
            "enabled": _ACTIVE,
            "launches": _counters["launches"],
            "builds": _counters["builds"],
            "site_count": len(_sites),
            "rebuild_count": len(_rebuilds),
            "late_build_count": len(_late_builds),
            "host_sync_count": len(_host_syncs),
            "sanctioned_fetches": _counters["sanctioned_fetches"],
            "sanctioned_by_tag": dict(_sanct_tags),
            "cuda_sync_warnings": _counters["cuda_sync_warnings"],
            "x64_leak_count": len(_dtype_drift),
            "mutation_count": len(_mutations),
            "reports_dropped": _counters["reports_dropped"],
            "rebuilds": [dict(r) for r in _rebuilds],
            "late_builds": [dict(r) for r in _late_builds],
            "host_syncs": [dict(r) for r in _host_syncs],
            "dtype_drift": [dict(r) for r in _dtype_drift],
            "mutations": [dict(r) for r in _mutations],
        }
        if sites:
            out["sites"] = [
                {"site": s, "launches": r["launches"],
                 "builds": r["builds"], "sigs": len(r["sigs"]),
                 "steady": r["steady"],
                 "host_setup_repeats": (
                     None if r["host_setup"] is None
                     else sum(r["host_setup"].values()))}
                for s, r in _sites.items()]
    return out


def _reset_for_tests() -> None:
    with _slock:
        _sites.clear()
        _rebuilds.clear()
        _rebuild_keys.clear()
        _late_builds.clear()
        _late_keys.clear()
        _host_syncs.clear()
        _host_sync_keys.clear()
        _dtype_drift.clear()
        _dtype_keys.clear()
        _mutations.clear()
        _mutation_keys.clear()
        _fps.clear()
        _frozen.clear()
        _fps_bytes[0] = _fps_bytes[1] = 0
        _rehash_cursor[0] = 0
        _sanct_tags.clear()
        _launched[0] = False
        for k in _counters:
            _counters[k] = 0
