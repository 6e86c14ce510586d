"""The plan applier's half of the flat allocation table (port of the
verify half of nomad_tpu/state/alloc_table.py AllocTable).

Every alloc write updates fixed-width numpy rows -- the node slot, the
cpu / memory / disk ask, ``live_strict`` (not terminal by the applier's
filter: desired stop or evict, or client-terminal) and ``special`` (the
alloc holds ports, networks, reserved cores or devices, which the
cpu / memory / disk pre-pass cannot model) -- and adjusts per-slot fold
columns in place (``vc`` / ``vm`` / ``vd``: the live usage of each node
slot; ``vspec``: its count of live special rows). The plan applier
reads a node's committed usage from those columns (``fold_verify``)
instead of walking its allocations.

The reference's table also carries the scheduler's ``live`` column, the
port columns, the job hashes, ``pack`` / ``count_placed`` and
``compact``; the port's packs fold usage their own way
(tensor/pack.py), so they are left out here.

``version`` counts the table's mutations, as the reference's does:
every mutator call bumps it, so a reader that sees it move during one
read, or between two reads of one verify, saw two states (the
snapshot-isolation sanitizer, statecheck.py, reads it).

Guarded by the owning StateStore's lock: every mutator is called with
it held.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

_ROW_COLUMNS = (("node_slot", np.int32, -1), ("cpu", np.float64, 0),
                ("mem", np.float64, 0), ("disk", np.float64, 0),
                ("live_strict", np.uint8, 0), ("special", np.uint8, 0))
_FOLDS = ("vc", "vm", "vd")


class AllocTable:
    """(reference: state/alloc_table.py:48 AllocTable, verify half)"""

    def __init__(self, initial_capacity: int = 1024):
        self.version = 0
        self._row_of: Dict[str, int] = {}
        self._free: list = []
        self.n_rows = 0
        self._cap = initial_capacity
        for name, dtype, fill in _ROW_COLUMNS:
            setattr(self, name, np.full(initial_capacity, fill, dtype=dtype))
        # node axis
        self._slot_of_node: Dict[str, int] = {}
        self.n_nodes = 0
        self._node_cap = 256
        # per-slot fold columns under live_strict, built on first use and
        # then adjusted by every upsert and remove; vspec is a COUNT of
        # live special rows (reversible, unlike a boolean OR)
        self._fold_inc: Optional[dict] = None

    # -- the node axis ---------------------------------------------------
    def register_node(self, node) -> int:
        """The node's slot, allocated on its first registration
        (reference :100)."""
        self.version += 1
        slot = self._slot_of_node.get(node.id)
        if slot is None:
            if self.n_nodes == self._node_cap:
                grow = self._node_cap
                self._node_cap *= 2
                inc = self._fold_inc
                if inc is not None:
                    # new slots carry zero usage by definition
                    for k, arr in inc.items():
                        inc[k] = np.concatenate(
                            [arr, np.zeros(grow, dtype=arr.dtype)])
            slot = self.n_nodes
            self._slot_of_node[node.id] = slot
            self.n_nodes += 1
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
            lives = (self.live_strict[:n] > 0) & (slots >= 0)
            ms = slots[lives]
            np.add.at(inc["vc"], ms, self.cpu[:n][lives])
            np.add.at(inc["vm"], ms, self.mem[:n][lives])
            np.add.at(inc["vd"], ms, self.disk[:n][lives])
            np.add.at(inc["vspec"],
                      slots[lives & (self.special[:n] > 0)], 1)
        self._fold_inc = inc
        return inc

    def _fold_inc_get(self) -> dict:
        inc = self._fold_inc
        return inc if inc is not None else self._fold_inc_build()

    def _fold_inc_row(self, row: int, sign: int) -> None:
        """Adjust the folds by one row's CURRENT column values (sign -1
        before overwriting or removing a row, +1 after writing it)."""
        inc = self._fold_inc
        slot = int(self.node_slot[row])
        if slot < 0 or not self.live_strict[row]:
            return
        inc["vc"][slot] += sign * self.cpu[row]
        inc["vm"][slot] += sign * self.mem[row]
        inc["vd"][slot] += sign * self.disk[row]
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
        lives = self.live_strict[r] > 0
        np.add.at(inc["vc"], s[lives], sign * self.cpu[r][lives])
        np.add.at(inc["vm"], s[lives], sign * self.mem[r][lives])
        np.add.at(inc["vd"], s[lives], sign * self.disk[r][lives])
        spec = lives & (self.special[r] > 0)
        np.add.at(inc["vspec"], s[spec], sign)

    def fold_parity_mismatch(self, atol: float = 1e-6) -> int:
        """The number of node slots whose incrementally kept fold differs
        from a fresh recount (0 = parity); the recount replaces the kept
        fold."""
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

    # -- rows --------------------------------------------------------------
    def _grow(self) -> None:
        self._cap *= 2
        for name, _, _ in _ROW_COLUMNS:
            setattr(self, name, np.resize(getattr(self, name), self._cap))

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
        self.live_strict[row] = 0 if alloc.terminal_status() else 1
        self.special[row] = 1 if ar.has_special_dimensions() else 0
        if self._fold_inc is not None:
            self._fold_inc_row(row, +1)

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
        crs = []
        special = []
        for a in allocs:
            ar = a.allocated_resources
            got = derived.get(id(ar))
            if got is None:
                got = derived[id(ar)] = (
                    ar.comparable(), 1 if ar.has_special_dimensions() else 0)
            crs.append(got[0])
            special.append(got[1])
        live_strict = [0 if a.terminal_status() else 1 for a in allocs]
        n_new = sum(1 for i in ids if i not in self._row_of)
        while self.n_rows + n_new - len(self._free) > self._cap:
            self._grow()
        self.version += 1
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
        self.live_strict[rows] = live_strict
        self.special[rows] = special
        if self._fold_inc is not None:
            self._fold_inc_rows(rows, +1)

    def remove(self, alloc_id: str) -> None:
        """Free the alloc's row (reference :416)."""
        row = self._row_of.pop(alloc_id, None)
        if row is None:
            return
        self.version += 1
        if self._fold_inc is not None:
            self._fold_inc_row(row, -1)
        self.live_strict[row] = 0
        self.special[row] = 0
        self.node_slot[row] = -1
        self._free.append(row)

    # -- the applier's fold -----------------------------------------------
    def _fold_verify_all(self):
        """Per SLOT (used_cpu, used_mem, used_disk, special_any) under
        live_strict, served from the incremental fold columns (reference
        :488)."""
        inc = self._fold_inc_get()
        n = self.n_nodes
        return (inc["vc"][:n], inc["vm"][:n], inc["vd"][:n],
                inc["vspec"][:n] > 0)

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
