"""The native control plane (port of nomad_tpu/native.py): ctypes
bindings for csrc/pack_kernels.cc, the host folds the scheduler's pack,
the placement service and the plan applier run, and their numpy forms.

The library is built at first use with ``$CXX`` (default ``g++``) and
the reference's flags (``-O3 -march=native -shared -fPIC``) plus
``-ffp-contract=off``, so no ``a*b + c`` is fused and every function
equals its numpy form bit for bit. It goes to
``build/nomad_tpu_torch/native-<key>/pack_kernels.so`` under the
repository root, where ``<key>`` hashes the source, the flags and the
compiler's predefined macros under ``-march=native`` (its version and
the host CPU's instruction sets: such code is not portable), so a
``build/`` carried from another host is rebuilt, never loaded.
Concurrent first uses (one per test worker) build under a lock file, to
a temporary name renamed into place, so no process loads a half-written
library. Delete the directory to force a rebuild. A failed
build raises with the compiler's output, and a library of another ABI
raises: nothing falls back to numpy while the switch is on.

It is bound with ``ctypes.CDLL``, so each call releases the interpreter
lock: a fold or a verify runs beside the scheduler's other threads.

Each entry point has three names: ``<fn>_native`` calls the library,
``<fn>_plain`` is the numpy form (the reference's fallback, in the same
order), and ``<fn>`` picks one by the switch.

Knob (read at each use):
  NOMAD_TPU_TORCH_NATIVE_CP=0   the plain paths: numpy folds, the Python
                                verify pre-pass, whole snapshot copies
                                and eager per-placement alloc metrics
                                (the reference's NOMAD_TPU_NATIVE_CP)
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

PORT_WORDS = 2048
MAX_PORTS_PER_ALLOC = 8

# bumped whenever the C ABI changes shape; a library of another version
# raises at load
ABI_VERSION = 3

PKG_DIR = Path(__file__).resolve().parent
SOURCE = PKG_DIR / "csrc" / "pack_kernels.cc"
BUILD_ROOT = PKG_DIR.parent / "build" / "nomad_tpu_torch"
CXX_FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-shared",
             "-fPIC")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
# the last build's seconds (0.0 when the library was already built)
build_seconds = 0.0


def native_cp_enabled() -> bool:
    """(reference :27) The native control plane's switch, default on;
    ``NOMAD_TPU_TORCH_NATIVE_CP=0`` gives the plain paths."""
    return os.environ.get("NOMAD_TPU_TORCH_NATIVE_CP", "") != "0"


# -- build and load ------------------------------------------------------
def _compiler() -> str:
    return os.environ.get("CXX") or "g++"


def _target_key(cxx: str) -> bytes:
    """The compiler's predefined macros under -march=native: its version
    and every instruction-set feature it targets on this host."""
    try:
        return subprocess.run(
            [cxx, "-march=native", "-E", "-dM", "-x", "c++", "-"],
            input="", capture_output=True, text=True,
            timeout=60).stdout.encode()
    except (OSError, subprocess.SubprocessError):
        return b""


def library_path(source: Path = SOURCE, root: Path = BUILD_ROOT) -> Path:
    """Where ``source`` builds under ``root`` on this host with this
    compiler."""
    cxx = _compiler()
    h = hashlib.sha256()
    for part in (source.read_bytes(), " ".join(CXX_FLAGS).encode(),
                 cxx.encode(), _target_key(cxx)):
        h.update(part)
        h.update(b"\0")
    return root / f"native-{h.hexdigest()[:16]}" / (source.stem + ".so")


def build(source: Path = SOURCE, root: Path = BUILD_ROOT) -> dict:
    """Compile ``source`` under ``root`` unless its library exists.
    Returns {"path", "seconds", "built"}; raises RuntimeError with the
    compiler's output if the build fails."""
    import fcntl
    lib = library_path(source, root)
    t0 = time.perf_counter()
    if lib.exists():
        return {"path": str(lib), "seconds": 0.0, "built": False}
    lib.parent.mkdir(parents=True, exist_ok=True)
    with open(lib.parent / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists():        # another process built it meanwhile
            return {"path": str(lib), "seconds": 0.0, "built": False}
        if shutil.which(_compiler()) is None:
            raise RuntimeError(f"native control plane: no C++ compiler "
                               f"{_compiler()!r} (set CXX)")
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        cmd = [_compiler(), *CXX_FLAGS, "-o", str(tmp), str(source)]
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=600)
        if r.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"native control plane: {' '.join(cmd)} failed "
                f"({r.returncode}):\n{r.stdout}{r.stderr}")
        os.replace(tmp, lib)
    return {"path": str(lib), "seconds": time.perf_counter() - t0,
            "built": True}


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Check the library's ABI and declare every entry point's
    arguments (reference :45 load)."""
    lib.nt_abi_version.restype = ctypes.c_int32
    got = lib.nt_abi_version()
    if got != ABI_VERSION:
        raise RuntimeError(f"native control plane: library ABI {got}, "
                           f"this module needs {ABI_VERSION}")
    d = ctypes.POINTER(ctypes.c_double)
    i32 = ctypes.POINTER(ctypes.c_int32)
    i64 = ctypes.POINTER(ctypes.c_int64)
    i8 = ctypes.POINTER(ctypes.c_int8)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    u32 = ctypes.POINTER(ctypes.c_uint32)
    u64 = ctypes.POINTER(ctypes.c_uint64)
    c_i32, c_i64, c_u64 = ctypes.c_int32, ctypes.c_int64, ctypes.c_uint64
    c_d = ctypes.c_double
    lib.nt_pack_usage.argtypes = [
        i32, d, d, d, u8, i32, c_i64, c_i32, i32, i32, d, d, d, i32, u32,
        c_i64]
    lib.nt_count_placed.argtypes = [
        i32, u64, u64, u8, c_i64, c_u64, c_u64, i32, i32, c_i64]
    lib.nt_static_ports_free.argtypes = [u32, c_i64, i32, c_i32, u8]
    lib.nt_verify_fit.argtypes = [d, d, d, d, d, d, d, d, d, c_i64, i32]
    lib.nt_verify_plan.argtypes = [
        d, d, d, u8,                    # table columns
        i64, i32, i8, c_i64,            # row deltas
        i32, d, d, d, i8, c_i64,        # direct ask entries
        d, d, d,                        # caps
        d, d, d, d, d, d,               # used / ask accumulators
        c_i64, i32]
    lib.nt_solve_eval.argtypes = [
        c_i32, d, d, d, d, d, d, i32, u8, c_u64, c_d, c_d, c_d, c_i32,
        c_i32, c_i32, c_d, c_i32, c_i32, i32, i32]
    lib.nt_shuffled_order.argtypes = [c_u64, c_i32, i32]
    for fn in (lib.nt_pack_usage, lib.nt_count_placed,
               lib.nt_static_ports_free, lib.nt_verify_fit,
               lib.nt_verify_plan, lib.nt_solve_eval, lib.nt_shuffled_order):
        fn.restype = None
    return lib


def load() -> ctypes.CDLL:
    """Build if needed and load the library (once per process)."""
    global _LIB, build_seconds
    with _LOCK:
        if _LIB is None:
            info = build(SOURCE, BUILD_ROOT)
            build_seconds = info["seconds"]
            _LIB = bind(ctypes.CDLL(info["path"]))
        return _LIB


def _need(ok: bool, what: str) -> None:
    """A shape the C loop relies on: it indexes without bounds."""
    if not ok:
        raise ValueError(f"native control plane: {what}")


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _usage_out(n_pad, n_rows, ports, port_words_seed):
    used = [np.zeros(n_pad, dtype=np.float64) for _ in range(3)]
    dyn_used = np.zeros(n_pad, dtype=np.int32)
    # the bitmap is 8 KiB a node: made only where port state exists
    has_ports = (ports is not None and n_rows
                 and bool((ports[:, 0] >= 0).any()))
    if port_words_seed is None and not has_ports:
        port_words = None
    else:
        port_words = (port_words_seed.copy() if port_words_seed is not None
                      else np.zeros((n_pad, PORT_WORDS), dtype=np.uint32))
    return used, dyn_used, port_words


# -- the alloc table's usage fold ------------------------------------------
def pack_usage_native(node_slot, cpu, mem, disk, live, ports, dyn_lo,
                      dyn_hi, n_pad: int, port_words_seed=None
                      ) -> Tuple[np.ndarray, ...]:
    """(reference :178) Fold the rows into node-axis usage in C:
    ``node_slot`` holds each row's position (-1: none), ``ports`` is
    (rows, MAX_PORTS_PER_ALLOC) int32 (-1 empty) or None to fold no port
    state. Returns (used_cpu, used_mem, used_disk, dyn_used,
    port_words); port_words is None when no port state exists."""
    n_rows = len(node_slot)
    (used_cpu, used_mem, used_disk), dyn_used, port_words = _usage_out(
        n_pad, n_rows, ports, port_words_seed)
    if not n_rows:
        return used_cpu, used_mem, used_disk, dyn_used, port_words
    _need(len(dyn_lo) >= n_pad and len(dyn_hi) >= n_pad,
          "dyn_lo / dyn_hi cover n_pad positions")
    _need(all(len(a) == n_rows for a in (cpu, mem, disk, live)),
          "one cpu, mem, disk and live value a row")
    _need(ports is None or ports.shape == (n_rows, MAX_PORTS_PER_ALLOC),
          "ports is (rows, MAX_PORTS_PER_ALLOC)")
    _need(port_words is None or (port_words.shape == (n_pad, PORT_WORDS)
                                 and port_words.dtype == np.uint32),
          "port_words_seed is (n_pad, PORT_WORDS) uint32")
    lib = load()
    node_slot = np.ascontiguousarray(node_slot, dtype=np.int32)
    cpu, mem, disk = (np.ascontiguousarray(a, dtype=np.float64)
                      for a in (cpu, mem, disk))
    live = np.ascontiguousarray(live, dtype=np.uint8)
    if ports is not None:
        ports = np.ascontiguousarray(ports, dtype=np.int32)
    dyn_lo = np.ascontiguousarray(dyn_lo, dtype=np.int32)
    dyn_hi = np.ascontiguousarray(dyn_hi, dtype=np.int32)
    lib.nt_pack_usage(
        _ptr(node_slot, ctypes.c_int32), _ptr(cpu, ctypes.c_double),
        _ptr(mem, ctypes.c_double), _ptr(disk, ctypes.c_double),
        _ptr(live, ctypes.c_uint8),
        _ptr(ports, ctypes.c_int32) if ports is not None else None,
        n_rows, MAX_PORTS_PER_ALLOC if ports is not None else 0,
        _ptr(dyn_lo, ctypes.c_int32), _ptr(dyn_hi, ctypes.c_int32),
        _ptr(used_cpu, ctypes.c_double), _ptr(used_mem, ctypes.c_double),
        _ptr(used_disk, ctypes.c_double), _ptr(dyn_used, ctypes.c_int32),
        (_ptr(port_words, ctypes.c_uint32)
         if port_words is not None else None), n_pad)
    return used_cpu, used_mem, used_disk, dyn_used, port_words


def pack_usage_plain(node_slot, cpu, mem, disk, live, ports, dyn_lo,
                     dyn_hi, n_pad: int, port_words_seed=None
                     ) -> Tuple[np.ndarray, ...]:
    """pack_usage_native's numpy form (reference :228), folding rows in
    row order."""
    n_rows = len(node_slot)
    (used_cpu, used_mem, used_disk), dyn_used, port_words = _usage_out(
        n_pad, n_rows, ports, port_words_seed)
    mask = (live != 0) & (node_slot >= 0) & (node_slot < n_pad)
    slots = node_slot[mask]
    np.add.at(used_cpu, slots, cpu[mask])
    np.add.at(used_mem, slots, mem[mask])
    np.add.at(used_disk, slots, disk[mask])
    if port_words is not None and ports is not None:
        for i in np.nonzero(mask)[0]:
            slot = node_slot[i]
            for p in ports[i]:
                if p < 0:
                    break
                if p >= 65536:
                    continue
                word, bit = p >> 5, np.uint32(1 << (p & 31))
                if not port_words[slot, word] & bit:
                    port_words[slot, word] |= bit
                    if dyn_lo[slot] <= p <= dyn_hi[slot]:
                        dyn_used[slot] += 1
    return used_cpu, used_mem, used_disk, dyn_used, port_words


def pack_usage(*args, **kwargs):
    """pack_usage_native, or its numpy form with the switch off."""
    fn = pack_usage_native if native_cp_enabled() else pack_usage_plain
    return fn(*args, **kwargs)


# -- placed counts ---------------------------------------------------------
def count_placed_native(node_slot, job_hash, jobtg_hash, live,
                        want_job: int, want_jobtg: int, n_pad: int
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """(reference :250) Per position: the task group's live rows and the
    job's live rows, in C."""
    placed = np.zeros(n_pad, dtype=np.int32)
    placed_job = np.zeros(n_pad, dtype=np.int32)
    n_rows = len(node_slot)
    if not n_rows:
        return placed, placed_job
    _need(all(len(a) == n_rows for a in (job_hash, jobtg_hash, live)),
          "one job hash, task group hash and live value a row")
    lib = load()
    node_slot = np.ascontiguousarray(node_slot, dtype=np.int32)
    job_hash = np.ascontiguousarray(job_hash, dtype=np.uint64)
    jobtg_hash = np.ascontiguousarray(jobtg_hash, dtype=np.uint64)
    live = np.ascontiguousarray(live, dtype=np.uint8)
    lib.nt_count_placed(
        _ptr(node_slot, ctypes.c_int32), _ptr(job_hash, ctypes.c_uint64),
        _ptr(jobtg_hash, ctypes.c_uint64), _ptr(live, ctypes.c_uint8),
        n_rows, want_job, want_jobtg, _ptr(placed, ctypes.c_int32),
        _ptr(placed_job, ctypes.c_int32), n_pad)
    return placed, placed_job


def count_placed_plain(node_slot, job_hash, jobtg_hash, live,
                       want_job: int, want_jobtg: int, n_pad: int
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """count_placed_native's numpy form (reference :270)."""
    placed = np.zeros(n_pad, dtype=np.int32)
    placed_job = np.zeros(n_pad, dtype=np.int32)
    mask = (live != 0) & (node_slot >= 0) & (node_slot < n_pad) & \
        (job_hash == np.uint64(want_job))
    np.add.at(placed_job, node_slot[mask], 1)
    mask_tg = mask & (jobtg_hash == np.uint64(want_jobtg))
    np.add.at(placed, node_slot[mask_tg], 1)
    return placed, placed_job


def count_placed(*args, **kwargs):
    """count_placed_native, or its numpy form with the switch off."""
    fn = count_placed_native if native_cp_enabled() else count_placed_plain
    return fn(*args, **kwargs)


# -- static ports ----------------------------------------------------------
def static_ports_free_native(port_words: np.ndarray,
                             check_ports: np.ndarray) -> np.ndarray:
    """(reference :278) Per node: every port of ``check_ports`` is free
    in its bitmap (ports outside 0..65535 are not checked)."""
    n_pad = port_words.shape[0]
    out = np.ones(n_pad, dtype=np.uint8)
    if not len(check_ports):
        return out.astype(bool)
    _need(port_words.ndim == 2 and port_words.shape[1] == PORT_WORDS,
          "port_words is (nodes, PORT_WORDS)")
    lib = load()
    pw = np.ascontiguousarray(port_words, dtype=np.uint32)
    cp = np.ascontiguousarray(check_ports, dtype=np.int32)
    lib.nt_static_ports_free(_ptr(pw, ctypes.c_uint32), n_pad,
                             _ptr(cp, ctypes.c_int32), len(cp),
                             _ptr(out, ctypes.c_uint8))
    return out.astype(bool)


def static_ports_free_plain(port_words: np.ndarray,
                            check_ports: np.ndarray) -> np.ndarray:
    """static_ports_free_native's numpy form (reference :293)."""
    out = np.ones(port_words.shape[0], dtype=bool)
    for p in check_ports:
        if 0 <= p < 65536:
            out &= (port_words[:, int(p) >> 5]
                    & np.uint32(1 << (int(p) & 31))) == 0
    return out


def static_ports_free(*args, **kwargs):
    """static_ports_free_native, or its numpy form with the switch off."""
    fn = (static_ports_free_native if native_cp_enabled()
          else static_ports_free_plain)
    return fn(*args, **kwargs)


# -- the applier's verify --------------------------------------------------
def verify_fit_native(cpu_cap, mem_cap, disk_cap, used_cpu, used_mem,
                      used_disk, ask_cpu, ask_mem, ask_disk) -> np.ndarray:
    """(reference :301) The failing dimension per node: 0 fits, 1 cpu,
    2 memory, 3 disk."""
    n = len(cpu_cap)
    out = np.zeros(n, dtype=np.int32)
    if not n:
        return out
    args = [np.ascontiguousarray(a, dtype=np.float64) for a in
            (cpu_cap, mem_cap, disk_cap, used_cpu, used_mem, used_disk,
             ask_cpu, ask_mem, ask_disk)]
    _need(all(len(a) == n for a in args), "one value a node in each array")
    lib = load()
    lib.nt_verify_fit(*[_ptr(a, ctypes.c_double) for a in args], n,
                      _ptr(out, ctypes.c_int32))
    return out


def verify_fit_plain(cpu_cap, mem_cap, disk_cap, used_cpu, used_mem,
                     used_disk, ask_cpu, ask_mem, ask_disk) -> np.ndarray:
    """verify_fit_native's numpy form (reference :315)."""
    out = np.where(used_cpu + ask_cpu > cpu_cap, 1,
                   np.where(used_mem + ask_mem > mem_cap, 2,
                            np.where(used_disk + ask_disk > disk_cap, 3, 0)))
    return out.astype(np.int32)


def verify_fit(*args):
    """verify_fit_native, or its numpy form with the switch off."""
    fn = verify_fit_native if native_cp_enabled() else verify_fit_plain
    return fn(*args)


def verify_plan_native(tbl_cpu, tbl_mem, tbl_disk, tbl_live_strict, d_row,
                       d_pos, d_sign, a_pos, a_cpu, a_mem, a_disk,
                       a_into_used, cpu_cap, mem_cap, disk_cap, used_cpu,
                       used_mem, used_disk) -> np.ndarray:
    """(reference :321) Whole-group plan verification in one call: the
    row-backed deltas ``used[d_pos] += d_sign * tbl[d_row]`` where the
    row is live_strict, then the direct entries (into used for the
    in-flight overlay's adds, into ask for this plan's placements), in
    order, then ``used + ask`` against the caps. Mutates used_* in
    place; returns the failing dimension per node (0 fits, 1 cpu, 2
    memory, 3 disk)."""
    n = len(cpu_cap)
    out = np.zeros(n, dtype=np.int32)
    if not n:
        return out
    lib = load()
    asks = [np.zeros(n, dtype=np.float64) for _ in range(3)]
    tbl = [np.ascontiguousarray(a, dtype=np.float64)
           for a in (tbl_cpu, tbl_mem, tbl_disk)]
    ls = np.ascontiguousarray(tbl_live_strict, dtype=np.uint8)
    d_row = np.ascontiguousarray(d_row, dtype=np.int64)
    d_pos = np.ascontiguousarray(d_pos, dtype=np.int32)
    d_sign = np.ascontiguousarray(d_sign, dtype=np.int8)
    a_pos = np.ascontiguousarray(a_pos, dtype=np.int32)
    a_vals = [np.ascontiguousarray(a, dtype=np.float64)
              for a in (a_cpu, a_mem, a_disk)]
    a_iu = np.ascontiguousarray(a_into_used, dtype=np.int8)
    caps = [np.ascontiguousarray(a, dtype=np.float64)
            for a in (cpu_cap, mem_cap, disk_cap)]
    for u in (used_cpu, used_mem, used_disk):
        if u.dtype != np.float64 or not u.flags["C_CONTIGUOUS"]:
            raise ValueError("verify_plan updates float64 contiguous used "
                             "arrays in place")
    _need(all(len(a) == n for a in (*caps, used_cpu, used_mem, used_disk)),
          "one cap and used value a node")
    _need(all(len(a) == len(tbl[0]) for a in (*tbl, ls)),
          "table columns of one length")
    _need(len(d_pos) == len(d_sign) == len(d_row)
          and all(len(a) == len(a_pos) for a in (*a_vals, a_iu)),
          "one position, sign and value an entry")
    _need(not len(d_row) or (0 <= d_row.min() and d_row.max() < len(ls)),
          "delta rows inside the table")
    _need(all(not len(p) or (0 <= p.min() and p.max() < n)
              for p in (d_pos, a_pos)), "entry positions inside the nodes")
    lib.nt_verify_plan(
        *[_ptr(a, ctypes.c_double) for a in tbl], _ptr(ls, ctypes.c_uint8),
        _ptr(d_row, ctypes.c_int64), _ptr(d_pos, ctypes.c_int32),
        _ptr(d_sign, ctypes.c_int8), len(d_row),
        _ptr(a_pos, ctypes.c_int32),
        *[_ptr(a, ctypes.c_double) for a in a_vals],
        _ptr(a_iu, ctypes.c_int8), len(a_pos),
        *[_ptr(a, ctypes.c_double) for a in caps],
        *[_ptr(a, ctypes.c_double) for a in (used_cpu, used_mem, used_disk)],
        *[_ptr(a, ctypes.c_double) for a in asks], n,
        _ptr(out, ctypes.c_int32))
    return out


def verify_plan_plain(tbl_cpu, tbl_mem, tbl_disk, tbl_live_strict, d_row,
                      d_pos, d_sign, a_pos, a_cpu, a_mem, a_disk,
                      a_into_used, cpu_cap, mem_cap, disk_cap, used_cpu,
                      used_mem, used_disk) -> np.ndarray:
    """verify_plan_native's sequential form (reference :370): entries
    apply one at a time in order, as the C loop applies them."""
    n = len(cpu_cap)
    ask_c, ask_m, ask_d = (np.zeros(n, dtype=np.float64) for _ in range(3))
    for e in range(len(d_row)):
        row = int(d_row[e])
        if not tbl_live_strict[row]:
            continue
        k, s = int(d_pos[e]), float(d_sign[e])
        used_cpu[k] += s * tbl_cpu[row]
        used_mem[k] += s * tbl_mem[row]
        used_disk[k] += s * tbl_disk[row]
    for e in range(len(a_pos)):
        k = int(a_pos[e])
        if a_into_used[e]:
            used_cpu[k] += a_cpu[e]
            used_mem[k] += a_mem[e]
            used_disk[k] += a_disk[e]
        else:
            ask_c[k] += a_cpu[e]
            ask_m[k] += a_mem[e]
            ask_d[k] += a_disk[e]
    return verify_fit_plain(cpu_cap, mem_cap, disk_cap, used_cpu, used_mem,
                            used_disk, ask_c, ask_m, ask_d)


# -- the compiled host oracle ------------------------------------------------
def shuffled_order_native(seed: int, n: int) -> np.ndarray:
    """(reference :125) The per-eval Fisher-Yates permutation of
    scheduler/util.py shuffled_order, in C."""
    out = np.empty(n, dtype=np.int32)
    load().nt_shuffled_order(seed, n, _ptr(out, ctypes.c_int32))
    return out


def solve_eval_native(cpu_cap, mem_cap, disk_cap, used_cpu, used_mem,
                      used_disk, placed_jobtg, eligible, shuffle_seed: int,
                      ask_cpu: float, ask_mem: float, ask_disk: float,
                      desired_count: int, limit: int, n_placements: int,
                      spread_alg: bool = False, max_skip: int = 3,
                      skip_threshold: float = 0.0) -> np.ndarray:
    """(reference :137) The compiled host-baseline oracle:
    ``n_placements`` window-limited binpack selections with the usage
    carried (upstream scheduler/rank.go:205, stack.go:82-95). Mutates
    used_* and placed_jobtg in place; returns each placement's node
    index (-1: none). Its plain version is the host stack itself
    (scheduler/native_oracle.py)."""
    n = len(cpu_cap)
    for arr, dt in ((cpu_cap, np.float64), (mem_cap, np.float64),
                    (disk_cap, np.float64), (used_cpu, np.float64),
                    (used_mem, np.float64), (used_disk, np.float64),
                    (placed_jobtg, np.int32), (eligible, np.uint8)):
        if arr.dtype != dt or not arr.flags["C_CONTIGUOUS"]:
            raise ValueError("solve_eval requires contiguous typed arrays")
        _need(len(arr) == n, "one value a node in each array")
    lib = load()
    order = np.empty(n, dtype=np.int32)
    out_choice = np.empty(n_placements, dtype=np.int32)
    lib.nt_solve_eval(
        n, _ptr(cpu_cap, ctypes.c_double), _ptr(mem_cap, ctypes.c_double),
        _ptr(disk_cap, ctypes.c_double), _ptr(used_cpu, ctypes.c_double),
        _ptr(used_mem, ctypes.c_double), _ptr(used_disk, ctypes.c_double),
        _ptr(placed_jobtg, ctypes.c_int32), _ptr(eligible, ctypes.c_uint8),
        shuffle_seed, float(ask_cpu), float(ask_mem), float(ask_disk),
        desired_count, limit, max_skip, skip_threshold, n_placements,
        1 if spread_alg else 0, _ptr(order, ctypes.c_int32),
        _ptr(out_choice, ctypes.c_int32))
    return out_choice
