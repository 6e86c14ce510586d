"""The flat allocation table (port of nomad_tpu/state/alloc_table.py
AllocTable): the tensor-resident half of the state store.

Every alloc write updates fixed-width numpy rows -- the node slot, the
cpu / memory / disk ask, ``live`` (the scheduler's filter: not
client-terminal), ``live_strict`` (the applier's filter: not terminal
by desired stop or evict either), ``special`` (the alloc holds ports,
networks, reserved cores or devices, which the cpu / memory / disk
pre-pass cannot model), the job and job / task-group hashes and up to
MAX_PORTS ports -- and adjusts per-slot fold columns in place:
``uc`` / ``um`` / ``ud`` (each node slot's usage under ``live``),
``vc`` / ``vm`` / ``vd`` (under ``live_strict``) and ``vspec`` (its
count of live special rows).

Two halves read it. The scheduler's pack folds the table into
node-axis usage (``pack``, ``count_placed``: solver/service.py
_pack_usage_from_table) instead of walking every node's allocations;
the plan applier reads a node's committed usage (``fold_verify``).
``compact`` repacks the rows densely once GC has freed many
(state/store.py compact_alloc_table). The reference's folds run in a C
library where it is built; here they are numpy, the reference's own
fallback forms (``pack_usage``, ``count_placed`` below), folding rows in
row order.

``version`` counts the table's mutations, as the reference's does:
every mutator call bumps it, so a reader that sees it move during one
read, or between two reads of one verify, saw two states (the
snapshot-isolation sanitizer, statecheck.py, reads it).

Knob:
  NOMAD_TPU_TORCH_PACK_DELTA=0   the fold columns are not kept: every
                                 pack folds the rows, and the applier's
                                 fold is memoized per table version (the
                                 reference's wholesale path, its oracle)

Guarded by the owning StateStore's lock: every mutator is called with
it held.
"""
from __future__ import annotations

import hashlib
import os
from functools import lru_cache
from typing import Dict, Optional, Tuple

import numpy as np

MAX_PORTS = 8
PORT_WORDS = 2048

_ROW_COLUMNS = (("node_slot", np.int32, -1), ("cpu", np.float64, 0),
                ("mem", np.float64, 0), ("disk", np.float64, 0),
                ("live", np.uint8, 0), ("live_strict", np.uint8, 0),
                ("special", np.uint8, 0), ("job_hash", np.uint64, 0),
                ("jobtg_hash", np.uint64, 0))
_FOLDS = ("uc", "um", "ud", "vc", "vm", "vd")


def pack_delta_enabled() -> bool:
    """(reference :26) Keep the fold columns in step with every write;
    ``NOMAD_TPU_TORCH_PACK_DELTA=0`` drops them for the wholesale path."""
    return os.environ.get("NOMAD_TPU_TORCH_PACK_DELTA", "1") != "0"


@lru_cache(maxsize=65536)
def stable_hash(*parts: str) -> int:
    """(reference :37) The 64-bit blake2b of the parts, each followed by
    a NUL byte: the job and job / task-group keys of a row."""
    h = hashlib.blake2b(digest_size=8)
    for p in parts:
        h.update(p.encode())
        h.update(b"\0")
    return int.from_bytes(h.digest(), "little")


def pack_usage(node_slot: np.ndarray, cpu: np.ndarray, mem: np.ndarray,
               disk: np.ndarray, live: np.ndarray,
               ports: Optional[np.ndarray], dyn_lo: np.ndarray,
               dyn_hi: np.ndarray, n_pad: int,
               port_words_seed: Optional[np.ndarray] = None
               ) -> Tuple[np.ndarray, ...]:
    """(reference native.py:178, its numpy form) Fold the rows into
    node-axis usage: ``node_slot`` holds each row's position (-1: none).
    ``ports`` is (rows, MAX_PORTS) int32 (-1 empty) or None to fold no
    port state. Returns (used_cpu, used_mem, used_disk, dyn_used,
    port_words); port_words is None when no port state exists."""
    n_rows = len(node_slot)
    used_cpu = np.zeros(n_pad, dtype=np.float64)
    used_mem = np.zeros(n_pad, dtype=np.float64)
    used_disk = np.zeros(n_pad, dtype=np.float64)
    dyn_used = np.zeros(n_pad, dtype=np.int32)
    has_ports = (ports is not None and n_rows
                 and bool((ports[:, 0] >= 0).any()))
    if port_words_seed is None and not has_ports:
        port_words = None
    else:
        port_words = (port_words_seed.copy() if port_words_seed is not None
                      else np.zeros((n_pad, PORT_WORDS), dtype=np.uint32))
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


def count_placed(node_slot: np.ndarray, job_hash: np.ndarray,
                 jobtg_hash: np.ndarray, live: np.ndarray, want_job: int,
                 want_jobtg: int, n_pad: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """(reference native.py:250, its numpy form) Per position: the live
    rows of the task group, and of the job."""
    placed = np.zeros(n_pad, dtype=np.int32)
    placed_job = np.zeros(n_pad, dtype=np.int32)
    mask = (live != 0) & (node_slot >= 0) & (node_slot < n_pad) & \
        (job_hash == np.uint64(want_job))
    np.add.at(placed_job, node_slot[mask], 1)
    mask_tg = mask & (jobtg_hash == np.uint64(want_jobtg))
    np.add.at(placed, node_slot[mask_tg], 1)
    return placed, placed_job


class AllocTable:
    """(reference: state/alloc_table.py:48 AllocTable)"""

    def __init__(self, initial_capacity: int = 1024):
        self.version = 0
        self._row_of: Dict[str, int] = {}
        self._free: list = []
        self.n_rows = 0
        self._cap = initial_capacity
        for name, dtype, fill in _ROW_COLUMNS:
            setattr(self, name, np.full(initial_capacity, fill, dtype=dtype))
        self.ports = np.full((initial_capacity, MAX_PORTS), -1,
                             dtype=np.int32)
        self.rows_with_ports = 0
        # rows holding more than MAX_PORTS ports: the pack cannot fold
        # them, so the placement service walks the allocs instead
        self._overflow_rows: set = set()
        # node axis
        self._slot_of_node: Dict[str, int] = {}
        self.n_nodes = 0
        self._node_cap = 256
        self.dyn_lo = np.full(self._node_cap, 20000, dtype=np.int32)
        self.dyn_hi = np.full(self._node_cap, 32000, dtype=np.int32)
        # the applier's fold memoized per version: the
        # NOMAD_TPU_TORCH_PACK_DELTA=0 path only
        self._verify_fold_cache: Optional[tuple] = None
        # per-slot fold columns, built on first use and then adjusted by
        # every upsert and remove; vspec is a COUNT of live special rows
        # (reversible, unlike a boolean OR)
        self._fold_inc: Optional[dict] = None

    # -- the node axis ---------------------------------------------------
    def register_node(self, node) -> int:
        """The node's slot, allocated on its first registration
        (reference :100); its dynamic port range is (re)read (a node
        read by the journal alone, with no resources, keeps the default
        20000-32000)."""
        self.version += 1
        slot = self._slot_of_node.get(node.id)
        if slot is None:
            if self.n_nodes == self._node_cap:
                grow = self._node_cap
                self._node_cap *= 2
                self.dyn_lo = np.resize(self.dyn_lo, self._node_cap)
                self.dyn_hi = np.resize(self.dyn_hi, self._node_cap)
                inc = self._fold_inc
                if inc is not None:
                    # new slots carry zero usage by definition
                    for k, arr in inc.items():
                        inc[k] = np.concatenate(
                            [arr, np.zeros(grow, dtype=arr.dtype)])
            slot = self.n_nodes
            self._slot_of_node[node.id] = slot
            self.n_nodes += 1
        res = getattr(node, "node_resources", None)
        if res is not None:
            self.dyn_lo[slot] = res.min_dynamic_port
            self.dyn_hi[slot] = res.max_dynamic_port
        return slot

    def node_ids(self) -> list:
        """The registered nodes' ids, in slot order."""
        return list(self._slot_of_node)

    def node_slot_of(self, node_id: str) -> int:
        """(reference :216) -1 for a node the table never saw."""
        return self._slot_of_node.get(node_id, -1)

    # -- the incremental folds -------------------------------------------
    def _fold_inc_build(self) -> dict:
        """A full recount into the per-slot fold columns: the ground
        truth every delta adjustment stays equal to."""
        cap = self._node_cap
        inc = {k: np.zeros(cap) for k in _FOLDS}
        inc["vspec"] = np.zeros(cap, dtype=np.int64)
        n = self.n_rows
        if n:
            slots = self.node_slot[:n]
            ok = slots >= 0
            for filt, (c, m, d) in ((self.live, ("uc", "um", "ud")),
                                    (self.live_strict, ("vc", "vm", "vd"))):
                sel = (filt[:n] > 0) & ok
                s = slots[sel]
                np.add.at(inc[c], s, self.cpu[:n][sel])
                np.add.at(inc[m], s, self.mem[:n][sel])
                np.add.at(inc[d], s, self.disk[:n][sel])
            lives = (self.live_strict[:n] > 0) & ok
            np.add.at(inc["vspec"],
                      slots[lives & (self.special[:n] > 0)], 1)
        self._fold_inc = inc
        return inc

    def _fold_inc_get(self) -> Optional[dict]:
        """The fold columns, built on first use; None on the
        NOMAD_TPU_TORCH_PACK_DELTA=0 path."""
        if not pack_delta_enabled():
            return None
        inc = self._fold_inc
        return inc if inc is not None else self._fold_inc_build()

    def _fold_inc_row(self, row: int, sign: int) -> None:
        """Adjust the folds by one row's CURRENT column values (sign -1
        before overwriting or removing a row, +1 after writing it)."""
        inc = self._fold_inc
        slot = int(self.node_slot[row])
        if slot < 0:
            return
        c, m, d = self.cpu[row], self.mem[row], self.disk[row]
        if self.live[row]:
            inc["uc"][slot] += sign * c
            inc["um"][slot] += sign * m
            inc["ud"][slot] += sign * d
        if self.live_strict[row]:
            inc["vc"][slot] += sign * c
            inc["vm"][slot] += sign * m
            inc["vd"][slot] += sign * d
            if self.special[row]:
                inc["vspec"][slot] += sign

    def _fold_inc_rows(self, rows: np.ndarray, sign: int) -> None:
        """Vectorized _fold_inc_row over a row-index array."""
        inc = self._fold_inc
        if inc is None or not len(rows):
            return
        slots = self.node_slot[rows]
        ok = slots >= 0
        r, s = rows[ok], slots[ok]
        if not len(r):
            return
        for filt, (c, m, d) in ((self.live, ("uc", "um", "ud")),
                                (self.live_strict, ("vc", "vm", "vd"))):
            sel = filt[r] > 0
            np.add.at(inc[c], s[sel], sign * self.cpu[r][sel])
            np.add.at(inc[m], s[sel], sign * self.mem[r][sel])
            np.add.at(inc[d], s[sel], sign * self.disk[r][sel])
        spec = (self.live_strict[r] > 0) & (self.special[r] > 0)
        np.add.at(inc["vspec"], s[spec], sign)

    def fold_parity_mismatch(self, atol: float = 1e-6) -> int:
        """(reference :203) The number of node slots whose incrementally
        kept fold differs from a fresh recount (0 = parity); the recount
        replaces the kept fold."""
        saved = self._fold_inc
        if saved is None:
            return 0
        fresh = self._fold_inc_build()
        n = self.n_nodes
        bad = np.zeros(n, dtype=bool)
        for k in _FOLDS:
            bad |= np.abs(saved[k][:n] - fresh[k][:n]) > atol
        bad |= (saved["vspec"][:n] > 0) != (fresh["vspec"][:n] > 0)
        return int(bad.sum())

    def usage_by_node(self) -> Dict[str, tuple]:
        """(reference :219) Per node id: (used_cpu, used_mem, used_disk)
        under the scheduler's ``live`` filter, from the fold columns. On
        the NOMAD_TPU_TORCH_PACK_DELTA=0 path the fold is counted fresh
        and not kept. The caller holds the owning store's lock."""
        inc = self._fold_inc_get()
        if inc is None:
            inc = self._fold_inc_build()
            self._fold_inc = None
        return {nid: (float(inc["uc"][slot]), float(inc["um"][slot]),
                      float(inc["ud"][slot]))
                for nid, slot in self._slot_of_node.items()}

    # -- rows --------------------------------------------------------------
    def preallocate(self, capacity: int) -> None:
        """(reference :238) Grow the rows to ``capacity`` ahead of a
        large write, in one pass of doublings."""
        while self._cap < capacity:
            self._grow()

    def _grow(self) -> None:
        self._cap *= 2
        for name, _, _ in _ROW_COLUMNS:
            setattr(self, name, np.resize(getattr(self, name), self._cap))
        ports = np.full((self._cap, MAX_PORTS), -1, dtype=np.int32)
        ports[:self.ports.shape[0]] = self.ports
        self.ports = ports

    def _take_row(self, alloc_id: str) -> int:
        if self._free:
            row = self._free.pop()
        else:
            if self.n_rows == self._cap:
                self._grow()
            row = self.n_rows
            self.n_rows += 1
        self._row_of[alloc_id] = row
        return row

    def _write_ports(self, row: int, ports, had_ports: bool) -> None:
        """The row's port columns and the port counters, after its
        columns were reset to -1."""
        had_overflow = row in self._overflow_rows
        for pi, value in enumerate(ports[:MAX_PORTS]):
            self.ports[row, pi] = value
        if len(ports) > MAX_PORTS:
            self._overflow_rows.add(row)
        elif had_overflow:
            self._overflow_rows.discard(row)
        if ports and not had_ports:
            self.rows_with_ports += 1
        elif had_ports and not ports:
            self.rows_with_ports -= 1

    def upsert(self, alloc) -> None:
        """Insert or rewrite the alloc's row (reference :257)."""
        self.version += 1
        row = self._row_of.get(alloc.id)
        if row is None:
            row = self._take_row(alloc.id)
        elif self._fold_inc is not None:
            # retract the row's old contribution before overwriting
            # (fresh and freed rows contribute nothing: remove zeroes them)
            self._fold_inc_row(row, -1)
        ar = alloc.allocated_resources
        cr = ar.comparable()
        self.node_slot[row] = self._slot_of_node.get(alloc.node_id, -1)
        self.cpu[row] = cr.cpu_shares
        self.mem[row] = cr.memory_mb
        self.disk[row] = cr.disk_mb
        self.live[row] = 0 if alloc.client_terminal_status() else 1
        self.live_strict[row] = 0 if alloc.terminal_status() else 1
        self.special[row] = 1 if ar.has_special_dimensions() else 0
        self.job_hash[row] = stable_hash(alloc.namespace, alloc.job_id)
        self.jobtg_hash[row] = stable_hash(alloc.namespace, alloc.job_id,
                                           alloc.task_group)
        if self._fold_inc is not None:
            self._fold_inc_row(row, +1)
        had_ports = bool(self.ports[row, 0] >= 0)
        self.ports[row, :] = -1
        self._write_ports(row, ar.all_ports(), had_ports)

    def upsert_many(self, allocs) -> None:
        """A batch of upserts as one vectorized write a column (reference
        :306), leaving the same table as scalar upserts in order. A batch
        under 8 allocs, or one that repeats an alloc id, takes the scalar
        path."""
        if not len(allocs):
            return
        if len(allocs) < 8:
            for a in allocs:
                self.upsert(a)
            return
        ids = [a.id for a in allocs]
        if len(set(ids)) != len(ids):
            for a in allocs:
                self.upsert(a)
            return
        # derive everything before the first mutation: a raising alloc
        # must not leave reserved but unwritten rows. Allocs of one task
        # group often share their AllocatedResources: memoize by identity
        # (``allocs`` keeps every object alive meanwhile)
        derived: dict = {}
        crs, all_ports, special = [], [], []
        for a in allocs:
            ar = a.allocated_resources
            got = derived.get(id(ar))
            if got is None:
                got = derived[id(ar)] = (
                    ar.comparable(), ar.all_ports(),
                    1 if ar.has_special_dimensions() else 0)
            crs.append(got[0])
            all_ports.append(got[1])
            special.append(got[2])
        live = [0 if a.client_terminal_status() else 1 for a in allocs]
        live_strict = [0 if a.terminal_status() else 1 for a in allocs]
        job_hash = [stable_hash(a.namespace, a.job_id) for a in allocs]
        jobtg_hash = [stable_hash(a.namespace, a.job_id, a.task_group)
                      for a in allocs]
        self.version += 1
        n_new = sum(1 for i in ids if i not in self._row_of)
        while self.n_rows + n_new - len(self._free) > self._cap:
            self._grow()
        rows = np.empty(len(allocs), dtype=np.int64)
        existed = np.zeros(len(allocs), dtype=bool)
        for k, a in enumerate(allocs):
            row = self._row_of.get(a.id)
            if row is None:
                row = self._take_row(a.id)
            else:
                existed[k] = True
            rows[k] = row
        if self._fold_inc is not None:
            # retract reused rows' old contributions (fresh rows past the
            # old n_rows hold resize garbage: they MUST be skipped)
            self._fold_inc_rows(rows[existed], -1)
        slot_of = self._slot_of_node
        self.node_slot[rows] = [slot_of.get(a.node_id, -1) for a in allocs]
        self.cpu[rows] = [cr.cpu_shares for cr in crs]
        self.mem[rows] = [cr.memory_mb for cr in crs]
        self.disk[rows] = [cr.disk_mb for cr in crs]
        self.live[rows] = live
        self.live_strict[rows] = live_strict
        self.special[rows] = special
        self.job_hash[rows] = job_hash
        self.jobtg_hash[rows] = jobtg_hash
        if self._fold_inc is not None:
            self._fold_inc_rows(rows, +1)
        # reused rows may hold stale ports: reset every written row, as
        # the scalar path does, after reading what it had
        had_ports = self.ports[rows, 0] >= 0
        self.ports[rows, :] = -1
        if not any(all_ports) and not self._overflow_rows:
            self.rows_with_ports -= int(had_ports.sum())
        else:
            for k, ports in enumerate(all_ports):
                self._write_ports(int(rows[k]), ports, bool(had_ports[k]))

    @property
    def has_port_overflow(self) -> bool:
        """(reference :413) A row holds more ports than MAX_PORTS."""
        return bool(self._overflow_rows)

    def remove(self, alloc_id: str) -> None:
        """Free the alloc's row (reference :416)."""
        row = self._row_of.pop(alloc_id, None)
        if row is None:
            return
        self.version += 1
        if self._fold_inc is not None:
            self._fold_inc_row(row, -1)
        if self.ports[row, 0] >= 0:
            self.rows_with_ports -= 1
        self._overflow_rows.discard(row)
        self.live[row] = 0
        self.live_strict[row] = 0
        self.special[row] = 0
        self.node_slot[row] = -1
        self.ports[row, :] = -1
        self._free.append(row)

    # -- the scheduler's fold ---------------------------------------------
    def pack(self, n_pad: int, node_slots_for_pad: np.ndarray,
             with_ports: bool, port_words_seed: Optional[np.ndarray] = None
             ) -> dict:
        """(reference :434) The table folded into node-axis arrays in the
        caller's node order: ``node_slots_for_pad[i]`` is the table slot
        of the node at position i (or -1). Returns a dict of used_cpu,
        used_mem, used_disk, dyn_used, port_words (None without port
        state) and row_slots (each row's position, -1: none)."""
        n = self.n_rows
        remap = np.full(self.n_nodes + 1, -1, dtype=np.int32)
        valid = node_slots_for_pad >= 0
        remap[node_slots_for_pad[valid]] = \
            np.nonzero(valid)[0].astype(np.int32)
        row_slots = self.node_slot[:n]
        mapped = np.where(row_slots >= 0, remap[np.maximum(row_slots, 0)],
                          -1)
        # port state matters only to a task group with networks
        use_ports = with_ports and (self.rows_with_ports > 0
                                    or port_words_seed is not None)
        inc = None if use_ports else self._fold_inc_get()
        if inc is not None:
            # the kept per-slot fold gathered into the caller's order: a
            # portless lane sees what pack_usage returns with no ports
            sel = node_slots_for_pad[valid]
            out = {}
            for key, col in (("used_cpu", "uc"), ("used_mem", "um"),
                             ("used_disk", "ud")):
                arr = np.zeros(n_pad, dtype=np.float64)
                arr[valid] = inc[col][sel]
                out[key] = arr
            out.update(dyn_used=np.zeros(n_pad, dtype=np.int32),
                       port_words=None, row_slots=mapped)
            return out
        dyn_lo = np.full(n_pad, 20000, dtype=np.int32)
        dyn_hi = np.full(n_pad, 32000, dtype=np.int32)
        dyn_lo[valid] = self.dyn_lo[node_slots_for_pad[valid]]
        dyn_hi[valid] = self.dyn_hi[node_slots_for_pad[valid]]
        used_cpu, used_mem, used_disk, dyn_used, port_words = pack_usage(
            mapped.astype(np.int32), self.cpu[:n], self.mem[:n],
            self.disk[:n], self.live[:n],
            self.ports[:n] if use_ports else None, dyn_lo, dyn_hi, n_pad,
            port_words_seed=port_words_seed if with_ports else None)
        return {"used_cpu": used_cpu, "used_mem": used_mem,
                "used_disk": used_disk, "dyn_used": dyn_used,
                "port_words": port_words, "row_slots": mapped}

    def count_placed(self, n_pad: int, mapped_slots: np.ndarray,
                     namespace: str, job_id: str, tg_name: str):
        """(reference :596) Per position: (the task group's live rows,
        the job's live rows); ``mapped_slots`` is pack's row_slots."""
        n = self.n_rows
        return count_placed(
            mapped_slots.astype(np.int32), self.job_hash[:n],
            self.jobtg_hash[:n], self.live[:n],
            stable_hash(namespace, job_id),
            stable_hash(namespace, job_id, tg_name), n_pad)

    # -- the applier's fold -----------------------------------------------
    def _fold_verify_all(self):
        """Per SLOT (used_cpu, used_mem, used_disk, special_any) under
        live_strict (reference :488): the kept fold columns, or, on the
        NOMAD_TPU_TORCH_PACK_DELTA=0 path, one fold memoized per table
        version."""
        inc = self._fold_inc_get()
        n = self.n_nodes
        if inc is not None:
            return (inc["vc"][:n], inc["vm"][:n], inc["vd"][:n],
                    inc["vspec"][:n] > 0)
        cache = self._verify_fold_cache
        if cache is not None and cache[0] == self.version:
            return cache[1]
        rows = self.n_rows
        used_c, used_m, used_d = np.zeros(n), np.zeros(n), np.zeros(n)
        spec = np.zeros(n, dtype=bool)
        if rows and n:
            slots = self.node_slot[:rows]
            live = (self.live_strict[:rows] > 0) & (slots >= 0)
            m = slots[live]
            np.add.at(used_c, m, self.cpu[:rows][live])
            np.add.at(used_m, m, self.mem[:rows][live])
            np.add.at(used_d, m, self.disk[:rows][live])
            spec[slots[live & (self.special[:rows] > 0)]] = True
        folded = (used_c, used_m, used_d, spec)
        self._verify_fold_cache = (self.version, folded)
        return folded

    def fold_verify(self, node_ids):
        """Per node of ``node_ids``: (used_cpu, used_mem, used_disk,
        special_any, found) under the applier's liveness filter (reference
        :523). ``found[k]`` False: the table never saw the node, whose
        usage is zero. Fresh arrays: the caller adjusts them in place by
        the plan's deltas. The caller holds the owning store's lock."""
        npos = len(node_ids)
        slots = np.fromiter(
            (self._slot_of_node.get(i, -1) for i in node_ids),
            dtype=np.int32, count=npos)
        found = slots >= 0
        base_c, base_m, base_d, base_s = self._fold_verify_all()
        if not base_c.shape[0]:
            return (np.zeros(npos), np.zeros(npos), np.zeros(npos),
                    np.zeros(npos, dtype=bool), found)
        idx = np.where(found, slots, 0)
        used_c = np.where(found, base_c[idx], 0.0)
        used_m = np.where(found, base_m[idx], 0.0)
        used_d = np.where(found, base_d[idx], 0.0)
        spec_any = found & base_s[idx]
        return used_c, used_m, used_d, spec_any, found

    # -- compaction --------------------------------------------------------
    def compact(self) -> dict:
        """(reference :551) Repack the surviving rows densely into
        [0, k) in their row order, drop the freed rows and shrink the
        capacity to the smallest power of two from 1,024 that holds
        them. Returns the rows and capacity before and after."""
        items = sorted(self._row_of.items(), key=lambda kv: kv[1])
        k = len(items)
        src = np.fromiter((r for _, r in items), dtype=np.int64, count=k)
        old_rows, old_cap = self.n_rows, self._cap
        new_cap = 1024
        while new_cap < k:
            new_cap *= 2
        for name, dtype, fill in _ROW_COLUMNS:
            arr = np.full(new_cap, fill, dtype=dtype)
            arr[:k] = getattr(self, name)[src]
            setattr(self, name, arr)
        ports = np.full((new_cap, MAX_PORTS), -1, dtype=np.int32)
        ports[:k] = self.ports[src]
        self.ports = ports
        row_map = {int(old): i for i, old in enumerate(src)}
        self._overflow_rows = {row_map[r] for r in self._overflow_rows
                               if r in row_map}
        self._row_of = {aid: i for i, (aid, _) in enumerate(items)}
        self.rows_with_ports = int((self.ports[:k, 0] >= 0).sum()) if k \
            else 0
        self._free = []
        self.n_rows = k
        self._cap = new_cap
        self.version += 1
        self._verify_fold_cache = None
        self._fold_inc = None       # rebuilt from the dense rows on use
        return {"rows_before": old_rows, "rows_after": k,
                "cap_before": old_cap, "cap_after": new_cap}

    @property
    def free_rows(self) -> int:
        """(reference :593)"""
        return len(self._free)
