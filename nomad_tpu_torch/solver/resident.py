"""Device residency: content-keyed resident buffers, the journal-fed
version chain, the delta scatter and the per-shard pool of the mesh
route (port of nomad_tpu/solver/constcache.py).

Every dispatch ships its input tables through ``device_put_cached``,
and every copy to the card is counted: ``note_dispatch_bytes`` feeds the
``nomad.solver.dispatch_bytes`` series and the transfer ledger's mirror
(solver/xferobs.py), and each array is attributed to its tree group in
the ledger, shipped or resident.

  * The content cache. An array's fingerprint (BLAKE2b over dtype, shape
    and bytes) is looked up; a hit reuses the resident device buffer and
    ships nothing, a miss copies the array to the device and keeps the
    copy, tagged with the caller's ``version`` (the node table's index,
    for hygiene: a node-table write drops older entries). Arrays below
    the min-bytes floor always ship fresh. LRU bounds on entries and
    bytes cap what stays resident.
  * The version chain. With a ``delta_src`` = (store, token), an array
    that misses the content cache goes through ``chain_apply``: each
    dispatch-tree slot (tag, dtype, shape, occurrence) keeps the device
    buffer it shipped last time and a frozen host shadow of its content.
    When the store's alloc-delta journal covers the span since that
    buffer's version, only the bitwise-changed elements ship, and
    ``delta_scatter`` writes them into a new copy of the resident buffer
    on the device (``promote``); identical content ships nothing
    (``reuse``). A first sight installs wholesale (``install``); an
    uncovered span (``gap``) or a diff at least DELTA_MAX_FRAC of the
    table (``size``) re-ships wholesale and is counted.

  * The per-shard pool (``device_put_sharded_cached``). A table cut over
    a grid of cells (parallel/mesh.py) keeps one resident buffer per
    (slice content, cell): the key is the slice's fingerprint plus the
    cell's place in the grid and its device, so two cells on one card
    stay two entries, and a node-table write re-uploads only the cells
    whose slice changed. Its own entry bound; the MiB bound is shared.

The scatter never writes into its base buffer: the base may still sit in
the content cache under its old fingerprint, or be read by a dispatch in
flight. It moves raw bits (one entry point per element size), so -0.0
and NaN payloads survive exactly as a wholesale copy would carry them.
``delta_scatter`` takes the plain version only for a CPU tensor; a CUDA
tensor launches the kernel (csrc/delta_scatter.cu) or raises.

Knobs (read at each use):
  NOMAD_TPU_TORCH_CONST_CACHE            0 ships every array wholesale
                                         (kill switch)
  NOMAD_TPU_TORCH_CONST_CACHE_ENTRIES    content-cache entries (64)
  NOMAD_TPU_TORCH_CONST_CACHE_MB         content-cache MiB (256)
  NOMAD_TPU_TORCH_CONST_CACHE_MIN_BYTES  arrays below this always ship
                                         (4096)
  NOMAD_TPU_TORCH_CONST_CACHE_SHARD_ENTRIES  per-shard pool entries (512)
  NOMAD_TPU_TORCH_DELTA_STREAM           0 turns the version chain off
                                         (kill switch)
  NOMAD_TPU_TORCH_DELTA_CHAIN_MB         chain pool MiB (64)
  NOMAD_TPU_TORCH_DELTA_MAX_FRAC         largest delta payload, as a
                                         share of the table (0.25)
"""
from __future__ import annotations

import hashlib
import os
import threading
import time
import warnings
from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import jitcheck, kernels, statecheck
from ..device import DeviceLike, resolve_device
from ..server.telemetry import metrics
from ..server.tracing import tracer
from . import xferobs

_LOCK = threading.Lock()
_CACHE: "OrderedDict[tuple, _Entry]" = OrderedDict()
# the per-shard pool: (slice fingerprint, cell place, device) -> entry
_SHARD_CACHE: "OrderedDict[tuple, _Entry]" = OrderedDict()
# one entry per dispatch-tree slot, not per content: the buffer it
# shipped last generation and the frozen host shadow of that content
_CHAIN: "OrderedDict[tuple, _ChainEntry]" = OrderedDict()
_STATS = {
    "hits": 0,
    "misses": 0,
    "bytes_shipped_total": 0,
    "bytes_saved_total": 0,
    "invalidations": 0,
    "evictions": 0,
    "resident_bytes": 0,
    "shard_resident_bytes": 0,
    "shard_resident_hwm": 0,
    # the chain: promotions scatter a delta, reuses ship nothing,
    # fallbacks re-ship wholesale over a live entry (gap = span not
    # covered by the journal, size = diff payload over DELTA_MAX_FRAC)
    "delta_promotions": 0,
    "delta_reuses": 0,
    "delta_fallbacks": 0,
    "delta_gap_fallbacks": 0,
    "delta_size_fallbacks": 0,
    "delta_bytes_total": 0,
    "delta_touched_nodes_last": 0,
    "chain_resident_bytes": 0,
}


class _Entry:
    __slots__ = ("buf", "nbytes", "version", "created_at", "hits")

    def __init__(self, buf, nbytes: int, version: Optional[int]):
        self.buf = buf              # the resident tensor
        self.nbytes = nbytes
        self.version = version      # node-table index (hygiene only)
        self.created_at = time.time()
        self.hits = 0


class _ChainEntry:
    __slots__ = ("buf", "host", "nbytes", "version", "base_version",
                 "deltas_applied", "created_at", "hits")

    def __init__(self, buf, host: np.ndarray, nbytes: int,
                 version: Optional[int]):
        self.buf = buf              # device buffer at ``version``
        self.host = host            # frozen host shadow (the diff base)
        self.nbytes = nbytes
        self.version = version      # store index the buffer is at: the
        #                             journal coverage check reads it
        self.base_version = version  # version of the last wholesale put
        self.deltas_applied = 0      # scatters since that put
        self.created_at = time.time()
        self.hits = 0


def enabled() -> bool:
    return os.environ.get("NOMAD_TPU_TORCH_CONST_CACHE", "1") != "0"


def delta_stream_enabled() -> bool:
    """The version chain's switch; it rides the cache's (no resident
    buffers, nothing to delta against)."""
    return (enabled()
            and os.environ.get("NOMAD_TPU_TORCH_DELTA_STREAM", "1") != "0")


def _max_entries() -> int:
    try:
        return max(1, int(os.environ.get(
            "NOMAD_TPU_TORCH_CONST_CACHE_ENTRIES", "64")))
    except ValueError:
        return 64


def _max_bytes() -> int:
    try:
        return max(1, int(float(os.environ.get(
            "NOMAD_TPU_TORCH_CONST_CACHE_MB", "256")) * 1024 * 1024))
    except ValueError:
        return 256 * 1024 * 1024


def _min_bytes() -> int:
    try:
        return int(os.environ.get("NOMAD_TPU_TORCH_CONST_CACHE_MIN_BYTES",
                                  "4096"))
    except ValueError:
        return 4096


def _max_shard_entries() -> int:
    try:
        return max(1, int(os.environ.get(
            "NOMAD_TPU_TORCH_CONST_CACHE_SHARD_ENTRIES", "512")))
    except ValueError:
        return 512


def _chain_max_bytes() -> int:
    try:
        return max(1, int(float(os.environ.get(
            "NOMAD_TPU_TORCH_DELTA_CHAIN_MB", "64")) * 1024 * 1024))
    except ValueError:
        return 64 * 1024 * 1024


def _delta_max_frac() -> float:
    try:
        return float(os.environ.get("NOMAD_TPU_TORCH_DELTA_MAX_FRAC",
                                    "0.25"))
    except ValueError:
        return 0.25


def _fingerprint(arr: np.ndarray) -> bytes:
    h = hashlib.blake2b(digest_size=16)
    h.update(str((arr.dtype.str, arr.shape)).encode())
    h.update(np.ascontiguousarray(arr).data)
    return h.digest()


def _bitwise_changed(old: np.ndarray, new: np.ndarray) -> np.ndarray:
    """Flat indices of the elements whose bytes differ. Not ``!=`` on the
    values: -0.0 equals +0.0 and NaN never equals itself, but a promoted
    buffer must hold exactly the bytes a wholesale copy would. Elements
    of 1, 2, 4 or 8 bytes compare as unsigned integers of that width
    (equal integers, equal bytes); others byte by byte."""
    it = old.dtype.itemsize
    a = old.reshape((-1,))
    b = new.reshape((-1,))
    if it in (1, 2, 4, 8):
        bits = np.dtype("u%d" % it)
        return np.flatnonzero(a.view(bits) != b.view(bits))
    a = a.view(np.uint8).reshape(-1, it)
    b = b.view(np.uint8).reshape(-1, it)
    return np.flatnonzero((a != b).any(axis=1))


def _pad_updates(idx: np.ndarray, vals: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Pad (idx, vals) to the next power-of-two bucket (at least 8) by
    repeating slot 0: duplicate writes carry the same value, so the
    padded scatter is bit for bit the unpadded one."""
    n = int(idx.size)
    bucket = max(8, 1 << (n - 1).bit_length())
    pad = bucket - n
    idx_p = np.concatenate([idx, np.full(pad, idx[0], idx.dtype)])
    vals_p = np.concatenate([vals, np.repeat(vals[:1], pad)])
    return np.ascontiguousarray(idx_p, dtype=np.int32), \
        np.ascontiguousarray(vals_p), bucket


# --------------------------------------------------------------------------
# The delta scatter: out = a copy of buf with out.flat[idx] = vals.

# integer dtype of each element size: the scatter moves raw bits
_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


@jitcheck.plain_version
def delta_scatter_plain(buf: torch.Tensor, idx: torch.Tensor,
                        vals: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: a new tensor equal to ``buf`` with
    ``out.flat[idx[i]] = vals[i]``, written through an integer view so
    every bit pattern survives. Indices outside [0, buf.numel()) are
    dropped, as the reference's scatter drops them."""
    bits = _BITS[buf.element_size()]
    flat = buf.reshape(-1).view(bits)
    out = flat.clone()
    i = idx.reshape(-1).long()
    keep = (i >= 0) & (i < flat.numel())
    out[i[keep]] = vals.reshape(-1).view(bits)[keep]
    return out.view(buf.dtype).view(buf.shape)


def delta_scatter(buf: torch.Tensor, idx: torch.Tensor,
                  vals: torch.Tensor) -> torch.Tensor:
    """A new tensor equal to ``buf`` with ``out.flat[idx] = vals``; ``buf``
    is never written. ``idx`` is (k,) int32, ``vals`` (k,) of buf's dtype.
    The plain version for CPU tensors, the delta_scatter kernel for CUDA
    tensors."""
    for name, t in (("buf", buf), ("idx", idx), ("vals", vals)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.device != buf.device:
            raise ValueError(f"{name} is on {t.device}, expected "
                             f"{buf.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise TypeError("idx must be a 1-D int32 tensor")
    if vals.dtype != buf.dtype or vals.shape != idx.shape:
        raise TypeError(f"vals must be ({idx.shape[0]},) {buf.dtype}")
    if buf.element_size() not in _BITS:
        raise TypeError(f"no scatter for {buf.element_size()}-byte "
                        "elements")
    M = buf.numel()
    if M >= 1 << 31:
        raise ValueError("the scatter addresses fewer than 2^31 elements")
    dev = buf.device
    if dev.type == "cpu":
        return delta_scatter_plain(buf, idx, vals)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty_like(buf, memory_format=torch.contiguous_format)
    kernels.DELTA_SCATTER.launch(buf.dtype, [buf, idx, vals, out],
                                 [M, idx.shape[0]])
    return out


@jitcheck.plain_version
def coord_scatter_plain(part: torch.Tensor, coords: torch.Tensor,
                        vals: torch.Tensor, start: Sequence[int]
                        ) -> torch.Tensor:
    """Plain PyTorch version of the coordinate scatter into one cell's
    slice of a sharded table (parallel/mesh.py mesh_delta_scatter): a
    new tensor equal to ``part`` with ``out[c - start] = vals[i]`` for
    every update i whose coordinates c = coords[:, i] (in the whole
    table) fall inside the slice that begins at ``start``; the others
    belong to other cells and are dropped. Raw bits, as delta_scatter."""
    bits = _BITS[part.element_size()]
    out = part.reshape(-1).view(bits).clone()
    st = torch.tensor([int(x) for x in start], dtype=torch.long,
                      device=part.device)[:, None]
    dims = torch.tensor(list(part.shape), dtype=torch.long,
                        device=part.device)[:, None]
    local = coords.long() - st
    keep = ((local >= 0) & (local < dims)).all(dim=0)
    flat = torch.zeros(local.shape[1], dtype=torch.long, device=part.device)
    for d in range(local.shape[0]):
        flat = flat * int(part.shape[d]) + local[d]
    out[flat[keep]] = vals.reshape(-1).view(bits)[keep]
    return out.view(part.dtype).view(part.shape)


@jitcheck.plain_version
def coord_scatter_cells_plain(parts: Sequence[torch.Tensor], payload,
                              starts: Sequence[Sequence[int]]) -> list:
    """Plain version of coord_scatter_cells: coord_scatter_plain on each
    cell in turn."""
    coords, vals = payload
    return [coord_scatter_plain(p, coords, vals, st)
            for p, st in zip(parts, starts)]


_MAX_CELLS = 32                     # csrc/delta_scatter.cu kMaxCells


def coord_scatter_cells(parts: Sequence[torch.Tensor], payload,
                        starts: Sequence[Sequence[int]]) -> list:
    """The coordinate scatter into every cell of one device (see
    coord_scatter_plain): a new tensor per cell, ``parts`` never written.
    ``parts`` are the cells' slices, all of one shape, dtype and device;
    ``payload`` = (coords (ndim, k) int32 in whole-table coordinates,
    vals (k,) of the parts' dtype) on that device, shared by the cells
    (put_coord_payload ships it once); ``starts`` each slice's first
    coordinate per axis. The plain version for CPU tensors; for CUDA
    tensors one launch of the coordinate entry points of the
    delta_scatter source writes every cell (up to 32)."""
    coords, vals = payload
    parts = list(parts)
    if not parts or len(starts) != len(parts):
        raise ValueError("one start per part, at least one part")
    p0 = parts[0]
    if not isinstance(p0, torch.Tensor):
        raise TypeError("parts must be torch.Tensors")
    dev, dt, shape = p0.device, p0.dtype, p0.shape
    for t in parts:
        if not (isinstance(t, torch.Tensor) and t.device == dev
                and t.dtype == dt and t.shape == shape
                and t.is_contiguous()):
            raise ValueError("the parts must be contiguous tensors of one "
                             "shape, dtype and device")
    for name, t in (("coords", coords), ("vals", vals)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {dev}")
    ndim = len(shape)
    if not 1 <= ndim <= 4 or any(len(st) != ndim for st in starts):
        raise ValueError("the coordinate scatter takes 1 to 4 axes and "
                         "one start per axis")
    if coords.dtype != torch.int32 or coords.dim() != 2 \
            or coords.shape[0] != ndim:
        raise TypeError(f"coords must be ({ndim}, k) int32")
    if vals.dtype != dt or tuple(vals.shape) != (coords.shape[1],):
        raise TypeError(f"vals must be ({coords.shape[1]},) {dt}")
    if p0.element_size() not in _BITS:
        raise TypeError(f"no scatter for {p0.element_size()}-byte "
                        "elements")
    if p0.numel() >= 1 << 31:
        raise ValueError("the scatter addresses fewer than 2^31 elements")
    if dev.type == "cpu":
        return coord_scatter_cells_plain(parts, payload, starts)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    n = len(parts)
    if n > _MAX_CELLS:
        raise ValueError(f"{n} cells on {dev}: one launch takes at most "
                         f"{_MAX_CELLS}")
    outs = [torch.empty_like(t) for t in parts]
    kernels.COORD_SCATTER.launch(
        dt, [coords, vals, *parts, *outs],
        [ndim, coords.shape[1], n, *shape, *[1] * (4 - ndim)]
        + [int(x) for st in starts for x in (*st, *[0] * (4 - ndim))])
    return outs


# --------------------------------------------------------------------------
# Transfers.

def _host_tensor(arr: np.ndarray) -> torch.Tensor:
    """A tensor over ``arr``'s memory (read-only arrays included: every
    caller copies it before anything could write)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # non-writable
        return torch.from_numpy(np.ascontiguousarray(arr))


def _host_buffer(nbytes: int, pinned: bool):
    """A host byte buffer to stage an upload in: (uint8 tensor, numpy
    view of it). Page-locked for a card, from PyTorch's host allocator,
    which hands a block out again only after the asynchronous copies
    that read the tensor have run; plain numpy memory for the CPU, where
    a tensor's ``.numpy()`` would read as a fetch from the device to
    jitcheck."""
    if not pinned:
        h = np.empty(nbytes, dtype=np.uint8)
        # an empty buffer keeps a unit stride (views of it as other
        # dtypes need one)
        return (torch.from_numpy(h) if nbytes
                else torch.empty(0, dtype=torch.uint8)), h
    buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    return buf, buf.numpy()


def _put(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Wholesale host->device copy; on the CPU a tensor that owns its own
    copy (never an alias of a frozen shadow). To a card the bytes are
    staged in page-locked memory and copied asynchronously: a copy from
    pageable memory would make the host wait for the card inside the
    dispatch (the driver stages pageable memory itself, so the host
    copy is paid either way)."""
    t = _host_tensor(arr)
    if device.type == "cpu":
        return t.clone()
    if t.numel() == 0:
        return torch.empty(t.shape, dtype=t.dtype, device=device)
    host, h = _host_buffer(t.numel() * t.element_size(), True)
    h[:] = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    return host.to(device, non_blocking=True).view(t.dtype).reshape(
        t.shape)


def _stage_payload(idx_p: np.ndarray, vals_p: np.ndarray, pinned: bool):
    """The padded (idx, vals) payload in one host buffer: the int32
    indices, then the values' bytes from the next 16-byte boundary.
    Returns (uint8 tensor, offset of the values). ``pinned`` takes the
    buffer from PyTorch's page-locked host allocator, which hands a block
    out again only after the asynchronous copies that read it have run,
    so no later call rewrites a payload still in flight."""
    n_idx = int(idx_p.nbytes)
    off = -(-n_idx // 16) * 16
    host, h = _host_buffer(off + int(vals_p.nbytes), pinned)
    h[:n_idx] = np.ascontiguousarray(idx_p, dtype=np.int32).view(np.uint8)
    h[off:] = np.ascontiguousarray(vals_p).reshape(-1).view(np.uint8)
    return host, off


def put_coord_payload(coords: np.ndarray, vals: np.ndarray,
                      device: torch.device) -> tuple:
    """The coordinate scatter's payload on ``device`` in one host->device
    copy: (coords (ndim, k) int32, vals (k,)), staged as _stage_payload
    stages (page-locked for a card). Every cell of a device reads this
    one copy."""
    coords = np.ascontiguousarray(coords, dtype=np.int32)
    vals = np.ascontiguousarray(vals)
    dt = torch.from_numpy(np.empty(0, dtype=vals.dtype)).dtype
    host, off = _stage_payload(coords.reshape(-1), vals,
                               pinned=device.type == "cuda")
    pay = (host.to(device, non_blocking=True) if device.type == "cuda"
           else host)
    n = int(coords.size)
    return (pay[:4 * n].view(torch.int32).view(coords.shape),
            pay[off:].view(dt))


def _scatter_single(buf, idx_p: np.ndarray, vals_p: np.ndarray):
    """Ship the padded (idx, vals) payload in one host->device copy (as
    the reference's one device_put of both) and scatter it into a copy
    of ``buf`` on buf's device."""
    dev = buf.device
    host, off = _stage_payload(idx_p, vals_p, pinned=dev.type == "cuda")
    pay = host.to(dev, non_blocking=True) if dev.type == "cuda" else host
    n = int(idx_p.size)
    return delta_scatter(buf.reshape(-1), pay[:4 * n].view(torch.int32),
                         pay[off:].view(buf.dtype)).view(buf.shape)


def _evict_chain_over_bounds_locked() -> None:
    max_b = _chain_max_bytes()
    while _CHAIN and _STATS["chain_resident_bytes"] > max_b:
        _, ent = _CHAIN.popitem(last=False)
        _STATS["chain_resident_bytes"] -= ent.nbytes
        _STATS["evictions"] += 1


def chain_apply(key: tuple, arr: np.ndarray, store, token: Optional[int],
                put_fn, scatter=None, idx_width: int = 4,
                copy_shadow: bool = False, tag: Optional[str] = None):
    """Version-chain transfer of one array: reuse or delta-update the
    buffer this slot shipped last time. Returns (buffer, bytes_shipped,
    outcome), outcome one of install / reuse / promote / gap / size (see
    the module docstring). ``store.alloc_deltas_since(entry.version,
    upto=token)`` must report the span covered; the update itself is the
    bitwise host diff between the frozen shadow and ``arr``.

    Locking: never call this under ``_LOCK``. ``alloc_deltas_since``
    takes the store's lock, which nests outside ``_LOCK`` (the store's
    write hook calls note_table_write under it), so the entry is claimed
    under ``_LOCK``, evaluated here and reinstalled under ``_LOCK``; a
    concurrent claimant of the same slot installs wholesale and the last
    writer wins. ``put_fn(arr)`` is the wholesale upload; ``arr`` becomes
    the frozen shadow (callers pass fresh transport outputs), or a copy
    of it with ``copy_shadow`` (the mesh route's tables are views of
    arena buffers the next generation refills). ``scatter(buf, shape,
    idx_p, vals_p)`` replaces the flat single-buffer scatter (the mesh
    route's coordinate scatter), ``idx_width`` its bytes per update
    index (4 * ndim for coordinates). ``tag`` is the array's tree group
    in the transfer ledger (default ``key[0]``): a reused or promoted
    table counts as resident bytes and its delta payload ships under
    ``delta``; a wholesale outcome ships under the tag."""
    from ..tensor.pack import journal_touched_nodes

    nbytes = int(arr.nbytes)
    shadow = np.array(arr, copy=True) if copy_shadow else arr
    # the shadow is a promise about the resident buffer's content
    shadow.setflags(write=False)
    if jitcheck._ACTIVE:
        jitcheck.note_fingerprint(shadow)
    if statecheck._ACTIVE:
        statecheck.note_published(shadow, site="resident.chain")
    with _LOCK:
        ce = _CHAIN.pop(key, None)
        if ce is not None:
            _STATS["chain_resident_bytes"] -= ce.nbytes

    outcome = "install"
    payload = 0
    buf = None
    if ce is not None:
        covered = False
        pairs: list = []
        if (store is not None and token is not None
                and ce.version is not None):
            try:
                covered, pairs = store.alloc_deltas_since(
                    ce.version, upto=token)
            except Exception:
                # a journal that cannot answer cannot vouch: a counted
                # gap, the wholesale upload below
                covered = False
        if not covered or ce.nbytes != nbytes \
                or ce.host.dtype != shadow.dtype:
            outcome = "gap"
        else:
            if pairs:
                with _LOCK:
                    _STATS["delta_touched_nodes_last"] = len(
                        journal_touched_nodes(pairs))
            idx = _bitwise_changed(ce.host, shadow)
            if idx.size == 0:
                outcome = "reuse"
                buf = ce.buf
            elif shadow.size >= (1 << 31):
                outcome = "gap"   # int32 indices cannot address it
            else:
                idx_p, vals_p, bucket = _pad_updates(
                    idx, shadow.reshape((-1,))[idx])
                # int32 indices (or coordinates) and the values
                payload = bucket * (idx_width + shadow.dtype.itemsize)
                if payload >= _delta_max_frac() * nbytes:
                    outcome = "size"
                    payload = 0
                else:
                    outcome = "promote"
                    if scatter is None:
                        buf = _scatter_single(ce.buf, idx_p, vals_p)
                    else:
                        buf = scatter(ce.buf, shadow.shape, idx_p, vals_p)
    if buf is None:                       # install / gap / size
        buf = put_fn(shadow)
    shipped = payload if outcome in ("reuse", "promote") else nbytes

    with _LOCK:
        if outcome in ("reuse", "promote"):
            ne = ce
            ne.buf = buf
            ne.version = token
            ne.hits += 1
            if outcome == "promote":
                ne.host = shadow
                ne.deltas_applied += 1
        else:
            ne = _ChainEntry(buf, shadow, nbytes, token)
        if key in _CHAIN:
            # a concurrent claimant reinstalled first; last writer wins
            prev = _CHAIN.pop(key)
            _STATS["chain_resident_bytes"] -= prev.nbytes
        _CHAIN[key] = ne
        _STATS["chain_resident_bytes"] += nbytes
        if outcome == "promote":
            _STATS["delta_promotions"] += 1
            _STATS["delta_bytes_total"] += payload
        elif outcome == "reuse":
            _STATS["delta_reuses"] += 1
        elif outcome != "install":
            _STATS["delta_fallbacks"] += 1
            _STATS["delta_%s_fallbacks" % outcome] += 1
        _evict_chain_over_bounds_locked()
    # ledger attribution outside _LOCK (the ledger has its own lock)
    if xferobs.enabled():
        tag = tag if tag is not None else str(key[0])
        if outcome in ("reuse", "promote"):
            xferobs.note_payload(tag, nbytes, resident=True)
            if payload:
                xferobs.note_payload("delta", payload)
        else:
            xferobs.note_payload(tag, nbytes)
    if outcome == "promote":
        metrics.incr("nomad.solver.delta_promotions")
        metrics.sample("nomad.solver.delta_bytes", float(payload))
    elif outcome == "reuse":
        metrics.incr("nomad.solver.delta_reuses")
    elif outcome != "install":
        metrics.incr("nomad.solver.delta_fallbacks")
    return buf, shipped, outcome


def device_put_cached(arrays: Sequence[np.ndarray],
                      device: DeviceLike = None,
                      version: Optional[int] = None,
                      cacheable: Optional[Sequence[bool]] = None,
                      tags: Optional[Sequence[str]] = None,
                      delta_src=None) -> Tuple[List[torch.Tensor], int]:
    """Copy ``arrays`` to ``device`` (default ``cuda``), reusing resident
    buffers for repeated content. Returns (tensors, bytes_shipped).
    ``version`` tags new entries with the node table's index;
    ``cacheable`` masks which arrays may enter the content cache (the
    fused transport marks only the const tree's buffers); ``tags`` name
    each array's tree group (the chain's slot keys). ``delta_src`` =
    (store, token) routes arrays that miss the content cache through the
    version chain. Cacheable arrays are frozen (``write=False``): their
    fingerprint is a promise about their content. The returned tensors
    are shared with the cache: callers must not write into them."""
    dev = resolve_device(device)
    where = str(dev)

    def tag_of(i: int) -> str:
        return tags[i] if tags is not None else "untagged"

    def put(a):
        return _put(a, dev)

    arrays = [np.asarray(a) for a in arrays]
    if jitcheck._ACTIVE:
        jitcheck.note_tree(arrays)
    if not enabled():
        shipped = sum(a.nbytes for a in arrays)
        for i, a in enumerate(arrays):
            xferobs.note_payload(tag_of(i), a.nbytes)
        note_dispatch_bytes(shipped)
        return [put(a) for a in arrays], shipped

    store = token = None
    if delta_src is not None and delta_stream_enabled():
        store, token = delta_src
        if token is None or not hasattr(store, "alloc_deltas_since"):
            store = token = None
    chain_on = store is not None

    min_b = _min_bytes()
    buffers: List = [None] * len(arrays)
    miss_idx: List[int] = []
    miss_keys: List[Optional[tuple]] = []
    chain_jobs: List[Tuple[int, tuple, Optional[tuple]]] = []
    occ: dict = {}
    shipped = 0
    hits = misses = saved = 0
    hit_idx: List[int] = []
    with _LOCK:
        for i, arr in enumerate(arrays):
            if arr.nbytes < min_b:
                miss_idx.append(i)
                miss_keys.append(None)          # shipped, never cached
                shipped += arr.nbytes
                continue
            ck = None
            if cacheable is None or cacheable[i]:
                ck = (_fingerprint(arr), where)
                arr.setflags(write=False)
                if jitcheck._ACTIVE:
                    jitcheck.note_fingerprint(arr, ck[0])
                ent = _CACHE.get(ck)
                if ent is not None:
                    _CACHE.move_to_end(ck)
                    ent.hits += 1
                    buffers[i] = ent.buf
                    hits += 1
                    saved += ent.nbytes
                    hit_idx.append(i)
                    continue
                misses += 1
            if chain_on:
                # slot key: tree group, dtype, shape and occurrence within
                # this call -- stable across generations, because the
                # transports emit their trees in a fixed order
                sig = (tag_of(i), arr.dtype.str, arr.shape)
                k = occ.get(sig, 0)
                occ[sig] = k + 1
                chain_jobs.append((i, sig + (k, where), ck))
            else:
                miss_idx.append(i)
                miss_keys.append(ck)
                shipped += arr.nbytes
    if miss_idx:
        puts = [put(arrays[i]) for i in miss_idx]
        with _LOCK:
            for j, i in enumerate(miss_idx):
                buffers[i] = puts[j]
                ck = miss_keys[j]
                if ck is None:
                    continue
                # a concurrent dispatch may have installed the same
                # content since the lookup: replace it, counted once
                old = _CACHE.pop(ck, None)
                if old is not None:
                    _STATS["resident_bytes"] -= old.nbytes
                _CACHE[ck] = _Entry(puts[j], arrays[i].nbytes, version)
                _STATS["resident_bytes"] += arrays[i].nbytes
            _evict_over_bounds_locked()
    if chain_jobs:
        cache_adds: List[Tuple[int, tuple]] = []
        for (i, key, ck) in chain_jobs:
            buf, ship_i, outcome = chain_apply(key, arrays[i], store,
                                               token, put_fn=put,
                                               tag=tag_of(i))
            buffers[i] = buf
            shipped += ship_i
            if outcome in ("reuse", "promote"):
                saved += arrays[i].nbytes - ship_i
            if ck is not None:
                cache_adds.append((i, ck))
        if cache_adds:
            # the promoted (or installed) buffer enters the content cache
            # under the new content's fingerprint
            with _LOCK:
                for (i, ck) in cache_adds:
                    if ck not in _CACHE:
                        _CACHE[ck] = _Entry(buffers[i], arrays[i].nbytes,
                                            version)
                        _STATS["resident_bytes"] += arrays[i].nbytes
                _evict_over_bounds_locked()
    with _LOCK:
        _STATS["hits"] += hits
        _STATS["misses"] += misses
        _STATS["bytes_shipped_total"] += shipped
        _STATS["bytes_saved_total"] += saved
        resident_now = _STATS["resident_bytes"]
    # ledger attribution outside _LOCK: hit bytes are resident, every
    # array in miss_idx crossed to the device (chain slots were
    # attributed in chain_apply)
    for i in hit_idx:
        xferobs.note_payload(tag_of(i), arrays[i].nbytes, resident=True)
    for i in miss_idx:
        xferobs.note_payload(tag_of(i), arrays[i].nbytes)
    xferobs.note_resident_level(resident_now)
    if hits:
        metrics.incr("nomad.solver.const_cache_hit", hits)
    if misses:
        metrics.incr("nomad.solver.const_cache_miss", misses)
    note_dispatch_bytes(shipped)
    # per-eval attribution: a cold transfer explains its own latency
    # (the group ctx fans the event out to every fused lane)
    tracer.event("solver.constcache", hits=hits, misses=misses,
                 bytes_shipped=shipped, bytes_saved=saved)
    return buffers, shipped


def _evict_shard_over_bounds_locked() -> None:
    max_e, max_b = _max_shard_entries(), _max_bytes()
    while _SHARD_CACHE and (len(_SHARD_CACHE) > max_e
                            or _STATS["shard_resident_bytes"] > max_b):
        _, ent = _SHARD_CACHE.popitem(last=False)
        _STATS["shard_resident_bytes"] -= ent.nbytes
        _STATS["evictions"] += 1


def device_put_sharded_cached(arrays: Sequence[np.ndarray], cuts,
                              version: Optional[int] = None,
                              fallback_put=None, group: str = "mesh_const"):
    """Per-shard content-keyed transfer (reference constcache.py
    device_put_sharded_cached): ``cuts[i]`` lists array i's cells in
    grid order as (place, device, index) -- index the tuple of slices
    that cell holds. Each distinct slice is fingerprinted once; each cell
    reuses its resident buffer for that content or ships the slice and
    keeps it. Arrays below the min-bytes floor, and every array with the
    cache off, go through ``fallback_put(i)`` (the caller's whole-array
    put by spec) and count their whole bytes as shipped. Returns (per
    array the list of per-cell tensors, bytes shipped). The ledger takes
    the bytes under ``group`` (hits resident, the rest shipped) and one
    declared / actual row per cell."""
    arrays = [np.asarray(a) for a in arrays]
    min_b = _min_bytes()
    use_cache = enabled()
    parts_out: List = [None] * len(arrays)
    shipped = hits = misses = saved = hit_bytes = 0
    miss_puts = []
    with _LOCK:
        for i, arr in enumerate(arrays):
            if not use_cache or arr.nbytes < min_b:
                continue                     # the fallback, below
            parts: List = [None] * len(cuts[i])
            fp_by_slice: dict = {}
            for j, (place, dev, idx) in enumerate(cuts[i]):
                skey = tuple((s.start, s.stop, s.step) for s in idx)
                fp = fp_by_slice.get(skey)
                part = None
                if fp is None:
                    part = np.ascontiguousarray(arr[idx])
                    fp = _fingerprint(part)
                    fp_by_slice[skey] = fp
                key = (fp, int(place), str(dev))
                ent = _SHARD_CACHE.get(key)
                if ent is not None:
                    _SHARD_CACHE.move_to_end(key)
                    ent.hits += 1
                    parts[j] = ent.buf
                    hits += 1
                    saved += ent.nbytes
                    hit_bytes += ent.nbytes
                else:
                    if part is None:
                        part = np.ascontiguousarray(arr[idx])
                    miss_puts.append((i, j, dev, part, key))
                    misses += 1
                    shipped += part.nbytes
            parts_out[i] = parts
    # uploads outside the lock
    bufs = [_put(part, dev) for (_i, _j, dev, part, _k) in miss_puts]
    if miss_puts:
        with _LOCK:
            for (i, j, _dev, part, key), buf in zip(miss_puts, bufs):
                parts_out[i][j] = buf
                _SHARD_CACHE[key] = _Entry(buf, part.nbytes, version)
                _STATS["shard_resident_bytes"] += part.nbytes
            _evict_shard_over_bounds_locked()
    fresh_idx = [i for i, parts in enumerate(parts_out) if parts is None]
    for i in fresh_idx:
        parts_out[i] = fallback_put(i)
        shipped += arrays[i].nbytes
    with _LOCK:
        _STATS["hits"] += hits
        _STATS["misses"] += misses
        _STATS["bytes_shipped_total"] += shipped
        _STATS["bytes_saved_total"] += saved
        _STATS["shard_resident_hwm"] = max(_STATS["shard_resident_hwm"],
                                           _STATS["shard_resident_bytes"])
        shard_resident_now = _STATS["shard_resident_bytes"]
        shard_hwm = _STATS["shard_resident_hwm"]
        resident_now = _STATS["resident_bytes"] + shard_resident_now
    if xferobs.enabled():
        if hit_bytes:
            xferobs.note_payload(group, hit_bytes, resident=True)
        fresh_bytes = sum(arrays[i].nbytes for i in fresh_idx)
        miss_bytes = sum(p.nbytes for (_i, _j, _d, p, _k) in miss_puts)
        if fresh_bytes or miss_bytes:
            xferobs.note_payload(group, fresh_bytes + miss_bytes)
        note_cell_rows(group, [(a, [c[2] for c in cut])
                               for a, cut in zip(arrays, cuts)])
        xferobs.note_resident_level(resident_now)
    metrics.sample("nomad.solver.const_cache_shard_resident_bytes",
                   float(shard_resident_now))
    metrics.sample("nomad.solver.const_cache_shard_resident_hwm",
                   float(shard_hwm))
    if hits:
        metrics.incr("nomad.solver.const_cache_hit", hits)
    if misses:
        metrics.incr("nomad.solver.const_cache_miss", misses)
    note_dispatch_bytes(shipped)
    tracer.event("solver.constcache_sharded", hits=hits, misses=misses,
                 bytes_shipped=shipped, bytes_saved=saved)
    return parts_out, shipped


def note_cell_rows(group: str, tables) -> None:
    """One declared / actual row per cell in the transfer ledger for a
    tree cut over a grid: ``tables`` lists (array, per-cell index
    tuples in grid order). Declared is the cut's slice shape times the
    element size, actual the bytes of the slice the cell holds."""
    per_cell: dict = {}
    for arr, idxs in tables:
        arr = np.asarray(arr)
        for k, idx in enumerate(idxs):
            shape = [len(range(*s.indices(n))) for s, n in
                     zip(idx, arr.shape)] + list(arr.shape[len(idx):])
            declared = int(np.prod(shape, dtype=np.int64)) * arr.itemsize
            row = per_cell.setdefault(k, [0, 0])
            row[0] += declared
            row[1] += int(arr[idx].nbytes)
    for k in sorted(per_cell):
        xferobs.note_shard_bytes(group, f"d{k}", *per_cell[k])


def note_dispatch_bytes(n: int) -> None:
    """Record one dispatch's host->device payload (the bytes that crossed
    after resident hits): the ``nomad.solver.dispatch_bytes`` series, its
    running total, and the transfer ledger's mirror, which the ledger's
    tagged decomposition must equal (``xferobs.parity()``)."""
    metrics.sample("nomad.solver.dispatch_bytes", float(n))
    metrics.incr("nomad.solver.dispatch_bytes_total", int(n))
    xferobs.note_shipped(int(n))


def _evict_over_bounds_locked() -> None:
    max_e, max_b = _max_entries(), _max_bytes()
    while _CACHE and (len(_CACHE) > max_e
                      or _STATS["resident_bytes"] > max_b):
        _, ent = _CACHE.popitem(last=False)
        _STATS["resident_bytes"] -= ent.nbytes
        _STATS["evictions"] += 1


def residency() -> List[dict]:
    """One row per resident buffer: content-cache entries (bytes, upload
    version, age, hits), chain slots (with their last wholesale version
    and the deltas applied since) and per-shard entries (with their
    cell's place in the grid and its device)."""
    now = time.time()
    with _LOCK:
        rows = [{"id": ck[0].hex()[:12], "bytes": ent.nbytes,
                 "version": ent.version,
                 "age_s": round(now - ent.created_at, 1),
                 "hits": ent.hits}
                for ck, ent in _CACHE.items()]
        rows.extend(
            {"id": "chain:%s/%s/%s#%d" % (key[0], key[1],
                                          "x".join(map(str, key[2])),
                                          key[3]),
             "bytes": ent.nbytes, "version": ent.version,
             "base_version": ent.base_version,
             "deltas_applied": ent.deltas_applied,
             "age_s": round(now - ent.created_at, 1),
             "hits": ent.hits}
            for key, ent in _CHAIN.items())
        rows.extend(
            {"id": "shard:%s@%d" % (key[0].hex()[:12], key[1]),
             "bytes": ent.nbytes, "version": ent.version, "cell": key[1],
             "device": key[2], "age_s": round(now - ent.created_at, 1),
             "hits": ent.hits}
            for key, ent in _SHARD_CACHE.items())
        return rows


def chain_entries() -> list:
    """(device buffer, frozen host shadow) of every chain slot."""
    with _LOCK:
        return [(ce.buf, ce.host) for ce in _CHAIN.values()]


def note_table_write(tables, table_index: int, delta=None) -> None:
    """The state store's write hook: only node-table writes concern the
    content cache."""
    if "nodes" in tables:
        note_node_table_write(table_index)


def note_node_table_write(table_index: int) -> None:
    """Drop content-cache entries uploaded under an older node table.
    Correctness never depends on it (content keys validate themselves);
    it frees dead fleet versions before LRU pressure would. The chain
    survives: the journal's coverage check decides whether an old slot
    can still be advanced."""
    if not _CACHE and not _SHARD_CACHE:
        return
    with _LOCK:
        stale = [ck for ck, ent in _CACHE.items()
                 if ent.version is not None and ent.version < table_index]
        for ck in stale:
            ent = _CACHE.pop(ck)
            _STATS["resident_bytes"] -= ent.nbytes
        stale_s = [k for k, ent in _SHARD_CACHE.items()
                   if ent.version is not None and ent.version < table_index]
        for k in stale_s:
            ent = _SHARD_CACHE.pop(k)
            _STATS["shard_resident_bytes"] -= ent.nbytes
        if stale or stale_s:
            _STATS["invalidations"] += 1
        resident_now = (_STATS["resident_bytes"]
                        + _STATS["shard_resident_bytes"])
    if stale or stale_s:
        xferobs.note_resident_level(resident_now)


def invalidate_all(reason: str = "") -> None:
    """Drop every resident buffer (the dispatch guard's breaker calls this
    on a trip and on recovery: buffers that crossed a failed transport
    are not trusted). ``reason`` is for the caller's log."""
    del reason
    with _LOCK:
        had = bool(_CACHE) or bool(_SHARD_CACHE) or bool(_CHAIN)
        _CACHE.clear()
        _SHARD_CACHE.clear()
        _CHAIN.clear()
        _STATS["resident_bytes"] = 0
        _STATS["shard_resident_bytes"] = 0
        _STATS["chain_resident_bytes"] = 0
        if had:
            _STATS["invalidations"] += 1
    if had:
        xferobs.note_resident_level(0)


def stats() -> dict:
    with _LOCK:
        out = dict(_STATS)
        out["entries"] = len(_CACHE)
        out["shard_entries"] = len(_SHARD_CACHE)
        out["chain_entries"] = len(_CHAIN)
    out["enabled"] = enabled()
    out["delta_stream_enabled"] = delta_stream_enabled()
    return out


def _reset_for_tests() -> None:
    with _LOCK:
        _CACHE.clear()
        _SHARD_CACHE.clear()
        _CHAIN.clear()
        for k in _STATS:
            _STATS[k] = 0
