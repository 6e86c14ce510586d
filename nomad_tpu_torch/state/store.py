"""The alloc-delta journal of the state store (port of the journal half
of nomad_tpu/state/store.py StateStore).

Every logical write advances one raft-style index; a write to the allocs
table also appends ``(index, pairs)`` to a bounded journal, where
``pairs`` is the write's list of ``(old_alloc | None, new_alloc | None)``
change pairs, or None for a write that carries no structured delta (an
explicit coverage gap). ``alloc_deltas_since(index, upto)`` answers
whether the journal covers the span ``(index, upto]`` and with which
pairs: the device-resident version chain (solver/resident.py
chain_apply) admits a delta promotion only over a covered span.

Allocations are opaque here: a write needs only their ``id`` (and the
journal's readers their ``node_id``). The structs slice grows this class
into the full store (nodes, jobs, evals, snapshots) around the same
journal.

Knob (read when a store is built):
  NOMAD_TPU_TORCH_DELTA_JOURNAL   journal capacity in writes (default
                                  128, at least 8)
"""
from __future__ import annotations

import os
import sys
import threading
from collections import deque
from typing import Dict, Iterable, List, Optional, Tuple


def _delta_journal_cap() -> int:
    """Alloc-delta journal capacity (entries, one per alloc-table write).
    A span longer than the journal is uncoverable and forces its readers
    to a wholesale rebuild (counted in ``delta_journal_overflow``)."""
    try:
        return max(8, int(os.environ.get("NOMAD_TPU_TORCH_DELTA_JOURNAL",
                                         "128")))
    except ValueError:
        return 128


class StateStore:
    """Index bookkeeping and the bounded alloc-delta journal. A new store
    is at index 1 with every table at 1 and an empty journal, as the
    reference store is."""

    def __init__(self):
        self._lock = threading.RLock()
        self._index = 1
        self._table_index: Dict[str, int] = {}      # absent = 1
        self._allocs: Dict[str, object] = {}
        self._nodes: Dict[str, object] = {}
        # (index, pairs | None) per alloc-table write, oldest first
        self._alloc_deltas: deque = deque(maxlen=_delta_journal_cap())
        self.delta_journal_overflow = 0

    def latest_index(self) -> int:
        with self._lock:
            return self._index

    def table_index(self, *tables: str) -> int:
        with self._lock:
            return max(self._table_index.get(t, 1) for t in tables)

    def _bump(self, *tables: str, delta=None) -> int:
        """Advance the index for one logical write to ``tables``. An
        allocs write journals ``delta`` (its change pairs), and journals
        a None delta too: readers then know the span is not coverable."""
        with self._lock:
            self._index += 1
            for t in tables:
                self._table_index[t] = self._index
            if "allocs" in tables:
                self._alloc_deltas.append((self._index, delta))
            idx = self._index
            self._notify_write_hooks(tables, idx, delta)
            return idx

    @staticmethod
    def _notify_write_hooks(tables, index: int, delta) -> None:
        """Tell the resident buffer set of the write, if it is loaded (a
        store used without the solver never imports it)."""
        m = sys.modules.get("nomad_tpu_torch.solver.resident")
        hook = getattr(m, "note_table_write", None)
        if hook is not None:
            hook(tables, index, delta)

    def alloc_deltas_since(self, index: int, upto: Optional[int] = None
                           ) -> Tuple[bool, list]:
        """(covered, pairs): every (old, new) pair journaled for writes
        in (index, upto] (upto None = the allocs table's index).
        ``covered`` is False when the journal no longer reaches back to
        ``index`` or a write in the span carried no delta."""
        with self._lock:
            pairs: list = []
            hi = self._table_index.get("allocs", 1) if upto is None \
                else upto
            if not self._alloc_deltas:
                return (index >= self._table_index.get("allocs", 1)
                        or index >= hi), pairs
            oldest = self._alloc_deltas[0][0]
            if index < oldest - 1:
                # the journal wrapped past the reader's base index
                self.delta_journal_overflow += 1
                return False, pairs
            for idx, delta in self._alloc_deltas:
                if idx <= index or idx > hi:
                    continue
                if delta is None:
                    return False, []
                pairs.extend(delta)
            return True, pairs

    # -- writes ---------------------------------------------------------
    def upsert_node(self, node) -> int:
        """Register or replace a node (keyed by ``node.id``)."""
        with self._lock:
            self._nodes[node.id] = node
            return self._bump("nodes")

    def upsert_allocs(self, allocs: Iterable) -> int:
        """Insert or replace allocations (keyed by ``alloc.id``); the
        write journals one (existing | None, alloc) pair per alloc."""
        with self._lock:
            pairs: List[tuple] = []
            for alloc in allocs:
                pairs.append((self._allocs.get(alloc.id), alloc))
                self._allocs[alloc.id] = alloc
            return self._bump("allocs", delta=pairs)

    def delete_allocs(self, alloc_ids: Iterable[str]) -> int:
        """Remove allocations; journals (alloc, None) per removed one."""
        with self._lock:
            pairs = []
            for aid in alloc_ids:
                a = self._allocs.pop(aid, None)
                if a is not None:
                    pairs.append((a, None))
            return self._bump("allocs", delta=pairs)

    def replace_allocs(self, allocs: Iterable) -> int:
        """Replace the whole alloc table at once, as a snapshot restore
        does: no change-pair set exists, so the write journals an
        explicit coverage gap (delta None)."""
        with self._lock:
            self._allocs = {a.id: a for a in allocs}
            return self._bump("allocs")

    def allocs(self) -> list:
        with self._lock:
            return list(self._allocs.values())
