"""The state store (port of nomad_tpu/state/store.py StateStore and
StateSnapshot): nodes, jobs, evaluations, allocations, deployments,
namespaces, node pools and the scheduler configuration, point-in-time
snapshots, the plan-result commits (one plan, or a group of plans as one
transaction), blocking waits on the index, the alloc-delta journal, the
stored versions of every job, the scaling policies derived from each
job's groups and each job's scaling events, and the alloc table
(state/alloc_table.py: the scheduler's pack and the plan applier's
fold), kept in step with every alloc write and node registration and
compacted on request (compact_alloc_table). ``restore_from_snapshot``
replaces every table with a blob of state/restore.py ``dump_state``.

Every logical write advances one raft-style index exactly as the
reference's ``_bump`` does (``upsert_node`` one, ``upsert_job`` one,
``upsert_evals`` one, ``upsert_allocs`` one, ``upsert_deployment`` one,
``upsert_plan_results`` one, ``apply_plan_results_batch`` one for the
whole group, ``set_scheduler_config`` one, ``upsert_scaling_event`` one,
``restore_from_snapshot`` one; the leader's node, job, eval, alloc and
deployment writes one each, ``upsert_deployment_cas`` one when it
commits): the eval's
node shuffle is seeded by (eval id, latest_index), so a world written in
the same order lands on the same index and packs the same permutation.

A write to the allocs table also appends ``(index, pairs)`` to a bounded
journal, where ``pairs`` is the write's list of ``(old_alloc | None,
new_alloc | None)`` change pairs, or None for a write that carries no
structured delta (an explicit coverage gap). ``alloc_deltas_since(index,
upto)`` answers whether the journal covers the span ``(index, upto]``
and with which pairs: the device-resident version chain
(solver/resident.py chain_apply) and the placement service's usage
catch-up (solver/service.py _catch_up_usage_base) advance only over a
covered span.

Writes replace objects and never mutate them in place, so a snapshot
shares the store's objects safely. Every mapping keeps insertion order:
candidate rows and dense argmin ties follow it. The journal's readers
need only an allocation's ``id`` and ``node_id``; the other fields
(namespace, job id, indices) are read where present, and the alloc
table keeps a row only for an allocation that carries its resources.

Knob (read when a store is built):
  NOMAD_TPU_TORCH_DELTA_JOURNAL   journal capacity in writes (default
                                  128, at least 8)
"""
from __future__ import annotations

import copy
import hashlib
import os
import sys
import threading
import time
from collections import deque
from typing import Dict, Iterable, List, Optional, Tuple

from .. import schedcheck, statecheck
from ..faultinject import faults
from ..server.telemetry import metrics
from ..structs import (
    DesiredTransition, Namespace, NodePool, ScalingEvent, ScalingPolicy,
    SchedulerConfiguration)
from ..structs.node import NODE_SCHED_ELIGIBLE, NODE_SCHED_INELIGIBLE
from ..structs.job import JOB_STATUS_DEAD, JOB_STATUS_PENDING
from .alloc_table import AllocTable

# every table the port's store keeps (reference :28 TABLES, less the
# tables of layers the port has not: ACLs, the keyring, variables, CSI
# and the service catalog)
TABLES = ("nodes", "jobs", "evals", "allocs", "deployments", "node_pools",
          "scheduler_config", "job_versions", "scaling_policies",
          "scaling_events", "namespaces")
# scaling events kept a job (upstream: structs.JobTrackedScalingEvents)
SCALING_EVENTS_KEPT = 20


def _delta_journal_cap() -> int:
    """Alloc-delta journal capacity (entries, one per alloc-table write).
    A span longer than the journal is uncoverable and forces its readers
    to a wholesale rebuild (counted in ``delta_journal_overflow`` and the
    ``nomad.state.delta_journal_overflow`` series)."""
    try:
        return max(8, int(os.environ.get("NOMAD_TPU_TORCH_DELTA_JOURNAL",
                                         "128")))
    except ValueError:
        return 128


def _table_rows(allocs) -> list:
    """The allocs the alloc table keeps a row for: those that carry
    their resources (a stand-in with only ``id`` and ``node_id`` is read
    by the journal alone)."""
    return [a for a in allocs if hasattr(a, "allocated_resources")]


def _job_key(alloc) -> Tuple[str, str]:
    return (getattr(alloc, "namespace", "default"),
            getattr(alloc, "job_id", ""))


class StateSnapshot:
    """An immutable point-in-time view (reference: StateSnapshot). It
    shares the store's objects and exposes the store as ``_store`` (the
    alloc-delta journal the placement service and the resident buffer
    set read) and the store's live ``alloc_table`` (the plan applier's
    pre-pass reads it under the store's lock)."""

    def __init__(self, store: "StateStore"):
        with store._lock:
            self.index = store._index
            self.node_table_index = store._table_index.get("nodes", 1)
            self._nodes = dict(store._nodes)
            self._jobs = dict(store._jobs)
            self._evals = dict(store._evals)
            self._allocs = dict(store._allocs)
            self._deployments = dict(store._deployments)
            self._node_pools = dict(store._node_pools)
            self.alloc_table = store.alloc_table
            self._allocs_by_node = {k: dict(v) for k, v in
                                    store._allocs_by_node.items()}
            self._allocs_by_job = {k: dict(v) for k, v in
                                   store._allocs_by_job.items()}
            self._scheduler_config = store._scheduler_config
            self._store = store

    def latest_index(self) -> int:
        return self.index

    def node_by_id(self, node_id: str):
        return self._nodes.get(node_id)

    def nodes(self) -> list:
        return list(self._nodes.values())

    def ready_nodes_in_pool(self, pool: str = "all") -> list:
        """The ready nodes of a pool ("" or "all": every pool), memoized
        per snapshot with their id tuple (nodes_pack_key)."""
        return self._ready_memoized(("pool", pool))[0]

    def _ready_memoized(self, key):
        memo = self.__dict__.setdefault("_ready_memo", {})
        ent = memo.get(key)
        if ent is None:
            if key[0] == "pool":
                pool = key[1]
                out = [n for n in self._nodes.values() if n.ready()
                       and (pool in ("", "all") or n.node_pool == pool)]
            else:                       # ("dcs", pool, frozenset(dcs))
                base = self._ready_memoized(("pool", key[1]))[0]
                dcs = key[2]
                out = (base if "*" in dcs else
                       [n for n in base if n.datacenter in dcs])
            ent = memo.setdefault(key, (out, tuple(n.id for n in out)))
            self.__dict__.setdefault("_ready_by_id", {})[id(ent[0])] = \
                ent[1]
        return ent

    def ready_nodes_in_pool_dcs(self, pool: str, dcs: frozenset) -> list:
        """ready_nodes_in_pool with the job's datacenter filter ("*" in
        ``dcs``: every datacenter), memoized per snapshot in the same
        order, so the evals of one barrier generation share one list."""
        return self._ready_memoized(("dcs", pool, dcs))[0]

    def nodes_pack_key(self, nodes):
        """The node-id tuple of a list this snapshot's ready memo handed
        out (matched by identity), else None."""
        by_id = self.__dict__.get("_ready_by_id")
        return by_id.get(id(nodes)) if by_id else None

    def job_by_id(self, namespace: str, job_id: str):
        return self._jobs.get((namespace, job_id))

    def jobs(self) -> list:
        return list(self._jobs.values())

    def eval_by_id(self, eval_id: str):
        return self._evals.get(eval_id)

    def evals_by_job(self, namespace: str, job_id: str) -> list:
        return [e for e in self._evals.values()
                if e.namespace == namespace and e.job_id == job_id]

    def alloc_by_id(self, alloc_id: str):
        return self._allocs.get(alloc_id)

    def allocs(self) -> list:
        return list(self._allocs.values())

    def allocs_by_node(self, node_id: str) -> list:
        return [self._allocs[i] for i in self._allocs_by_node.get(node_id, ())
                if i in self._allocs]

    def allocs_by_node_terminal(self, node_id: str, terminal: bool) -> list:
        """(reference :270) The node's allocs whose terminal_status()
        is ``terminal``."""
        return [a for a in self.allocs_by_node(node_id)
                if a.terminal_status() == terminal]

    def allocs_by_job(self, namespace: str, job_id: str,
                      anyCreateIndex: bool = True) -> list:
        return [self._allocs[i]
                for i in self._allocs_by_job.get((namespace, job_id), ())
                if i in self._allocs]

    def allocs_by_eval(self, eval_id: str) -> list:
        return [a for a in self._allocs.values() if a.eval_id == eval_id]

    def deployment_by_id(self, deployment_id: str):
        return self._deployments.get(deployment_id)

    def deployments(self) -> list:
        return list(self._deployments.values())

    def node_pool_by_name(self, name: str):
        return self._node_pools.get(name)

    def latest_deployment_by_job(self, namespace: str, job_id: str):
        """The job's deployment with the highest create index."""
        best = None
        for d in self._deployments.values():
            if d.namespace == namespace and d.job_id == job_id:
                if best is None or d.create_index > best.create_index:
                    best = d
        return best

    def scheduler_config(self) -> SchedulerConfiguration:
        return self._scheduler_config


class StateStore:
    """The live, writable store. A new store is at index 1 with every
    table at 1 and an empty journal, as the reference store is."""

    def __init__(self):
        self._lock = threading.RLock()
        # block_until waits here; _bump notifies
        self._watch_cond = threading.Condition(self._lock)
        self._index = 1
        self._table_index: Dict[str, int] = {}      # absent = 1
        self._nodes: Dict[str, object] = {}
        self._jobs: Dict[Tuple[str, str], object] = {}
        # every stored version of every job, by (namespace, id, version)
        self._job_versions: Dict[Tuple[str, str, int], object] = {}
        self._evals: Dict[str, object] = {}
        self._allocs: Dict[str, object] = {}
        self._deployments: Dict[str, object] = {}
        self._namespaces: Dict[str, Namespace] = {
            "default": Namespace(name="default",
                                 description="Default shared namespace")}
        self._node_pools: Dict[str, NodePool] = {
            "default": NodePool(name="default"), "all": NodePool(name="all")}
        self._allocs_by_node: Dict[str, Dict[str, None]] = {}
        self._allocs_by_job: Dict[Tuple[str, str], Dict[str, None]] = {}
        self._scheduler_config = SchedulerConfiguration()
        self._scaling_policies: Dict[str, ScalingPolicy] = {}
        self._scaling_events: Dict[Tuple[str, str], List[ScalingEvent]] = {}
        self._snap_cache: Optional[StateSnapshot] = None
        # (index, pairs | None) per alloc-table write, oldest first
        self._alloc_deltas: deque = deque(maxlen=_delta_journal_cap())
        self.delta_journal_overflow = 0
        self.alloc_table = AllocTable()
        # the quality observatory's hook (server/quality.py), set by its
        # attach: it receives every write's tables and delta pairs beside
        # the module-level hooks. None (never attached, or
        # NOMAD_TPU_TORCH_QUALITY=0) is the prior path bit for bit.
        self._quality_hook = None

    def latest_index(self) -> int:
        with self._lock:
            return self._index

    def table_index(self, *tables: str) -> int:
        with self._lock:
            return max(self._table_index.get(t, 1) for t in tables)

    def block_until(self, min_index: int, timeout: float = 5.0,
                    tables: Tuple[str, ...] = ()) -> int:
        """Wait, at most ``timeout`` seconds, until the index (or the
        newest of ``tables``) passes ``min_index`` (reference :415).
        Returns the current index."""
        deadline = time.monotonic() + timeout
        with self._watch_cond:
            while True:
                cur = self.table_index(*tables) if tables else self._index
                if cur > min_index:
                    return self._index
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return self._index
                self._watch_cond.wait(remaining)

    def _bump(self, *tables: str, delta=None) -> int:
        """Advance the index for one logical write to ``tables``. An
        allocs write journals ``delta`` (its change pairs), and journals
        a None delta too: readers then know the span is not coverable."""
        if schedcheck._ACTIVE:
            # every index bump is a schedule decision point
            schedcheck.yield_point("store._bump")
        with self._lock:
            self._index += 1
            for t in tables:
                self._table_index[t] = self._index
            self._snap_cache = None
            if "allocs" in tables:
                self._alloc_deltas.append((self._index, delta))
            idx = self._index
            hook = self._quality_hook
            if hook is not None:
                hook(tables, idx, delta)
            self._notify_write_hooks(tables, idx, delta)
            self._watch_cond.notify_all()
            return idx

    @staticmethod
    def _notify_write_hooks(tables, index: int, delta) -> None:
        """Tell the resident buffer set and the pack caches of the write,
        where they are loaded (a store used without the solver never
        imports them)."""
        for name in ("nomad_tpu_torch.solver.resident",
                     "nomad_tpu_torch.tensor.pack"):
            hook = getattr(sys.modules.get(name), "note_table_write", None)
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
                metrics.incr("nomad.state.delta_journal_overflow")
                return False, pairs
            for idx, delta in self._alloc_deltas:
                if idx <= index or idx > hi:
                    continue
                if delta is None:
                    return False, []
                pairs.extend(delta)
            return True, pairs

    def snapshot(self) -> StateSnapshot:
        """One snapshot per index: any write starts a new one."""
        with self._lock:
            if self._snap_cache is None:
                self._snap_cache = StateSnapshot(self)
            return self._snap_cache

    # -- writes ---------------------------------------------------------
    def upsert_node(self, node) -> int:
        """Register or replace a node (keyed by ``node.id``). A
        re-registration keeps the operator's drain and eligibility; a
        node without a computed class gets one."""
        with self._lock:
            existing = self._nodes.get(node.id)
            if hasattr(node, "modify_index"):
                if existing is not None:
                    node.create_index = existing.create_index
                    if node.drain_strategy is None:
                        if existing.drain_strategy is not None:
                            node.drain_strategy = existing.drain_strategy
                        if existing.scheduling_eligibility:
                            node.scheduling_eligibility = \
                                existing.scheduling_eligibility
                else:
                    node.create_index = self._index + 1
                node.modify_index = self._index + 1
                if not node.computed_class:
                    node.compute_class()
            self._nodes[node.id] = node
            self.alloc_table.register_node(node)
            return self._bump("nodes")

    def delete_node(self, node_id: str) -> int:
        """(reference :599) Drop the node's record; its table slot
        stays, as the reference's does."""
        with self._lock:
            self._nodes.pop(node_id, None)
            return self._bump("nodes")

    def _node_write(self, node_id: str, **fields) -> int:
        """A copy of the stored node with ``fields`` set, in one write.
        Raises KeyError for an unknown node."""
        with self._lock:
            old = self._nodes.get(node_id)
            if old is None:
                raise KeyError(f"node {node_id} not found")
            node = copy.copy(old)
            for k, v in fields.items():
                setattr(node, k, v)
            node.modify_index = self._index + 1
            self._nodes[node_id] = node
            return self._bump("nodes")

    def update_node_eligibility(self, node_id: str, eligibility: str) -> int:
        """(reference :625)"""
        return self._node_write(node_id, scheduling_eligibility=eligibility)

    def update_node_drain(self, node_id: str, drain_strategy,
                          mark_eligible: bool = False) -> int:
        """(reference :640) Set or clear the node's drain: a drain makes
        the node ineligible; a cleared one makes it eligible again only
        with ``mark_eligible``."""
        fields = {"drain_strategy": drain_strategy}
        if drain_strategy is not None:
            fields["scheduling_eligibility"] = NODE_SCHED_INELIGIBLE
        elif mark_eligible:
            fields["scheduling_eligibility"] = NODE_SCHED_ELIGIBLE
        return self._node_write(node_id, **fields)

    def upsert_job(self, job) -> int:
        """Register or replace a job (keyed by namespace and id): a
        replacement is the next version. The job's scaling policies are
        derived again from its groups' scaling blocks."""
        with self._lock:
            key = (job.namespace, job.id)
            existing = self._jobs.get(key)
            if existing is not None:
                job.create_index = existing.create_index
                job.version = existing.version + 1
            else:
                job.create_index = self._index + 1
                job.version = 0
            job.modify_index = self._index + 1
            job.job_modify_index = self._index + 1
            if job.status != JOB_STATUS_DEAD:
                job.status = JOB_STATUS_PENDING
            self._jobs[key] = job
            self._job_versions[(job.namespace, job.id, job.version)] = job
            self._update_job_scaling_policies_locked(job)
            return self._bump("jobs", "job_versions")

    def _update_job_scaling_policies_locked(self, job) -> None:
        """(reference :678) One policy a group with a scaling block, its
        id a hash of (namespace, job, group); the job's other policies
        go. A block whose bounds are not integers is skipped (admission
        refuses it before a write)."""
        keep = set()
        for tg in job.task_groups:
            if not tg.scaling or not isinstance(tg.scaling, dict):
                continue
            pid = hashlib.sha1(
                f"{job.namespace}\x1f{job.id}\x1f{tg.name}".encode()
            ).hexdigest()[:36]
            keep.add(pid)
            existing = self._scaling_policies.get(pid)
            try:
                lo = int(tg.scaling.get("min", 0) or 0)
                hi = int(tg.scaling.get("max", tg.count))
            except (TypeError, ValueError):
                continue
            self._scaling_policies[pid] = ScalingPolicy(
                id=pid, namespace=job.namespace, job_id=job.id,
                type=str(tg.scaling.get("type", "horizontal")),
                target={"Namespace": job.namespace, "Job": job.id,
                        "Group": tg.name},
                min=lo, max=hi,
                policy=dict(tg.scaling.get("policy") or {}),
                enabled=bool(tg.scaling.get("enabled", True)),
                create_index=(existing.create_index if existing
                              else self._index + 1),
                modify_index=self._index + 1)
        for pid, pol in list(self._scaling_policies.items()):
            if (pol.namespace, pol.job_id) == (job.namespace, job.id) and \
                    pid not in keep:
                del self._scaling_policies[pid]
        self._table_index["scaling_policies"] = self._index + 1

    def delete_job(self, namespace: str, job_id: str) -> int:
        """(reference :737) The job, every stored version of it, its
        scaling policies and its scaling events."""
        with self._lock:
            self._jobs.pop((namespace, job_id), None)
            for k in [k for k in self._job_versions
                      if k[0] == namespace and k[1] == job_id]:
                del self._job_versions[k]
            for pid, pol in list(self._scaling_policies.items()):
                if (pol.namespace, pol.job_id) == (namespace, job_id):
                    del self._scaling_policies[pid]
            self._scaling_events.pop((namespace, job_id), None)
            return self._bump("jobs", "job_versions", "scaling_policies")

    def job_version(self, namespace: str, job_id: str, version: int):
        with self._lock:
            return self._job_versions.get((namespace, job_id, version))

    def job_versions_by_id(self, namespace: str, job_id: str) -> list:
        """(reference :754) Every stored version, newest first."""
        with self._lock:
            versions = [v for (ns, jid, _), v in self._job_versions.items()
                        if (ns, jid) == (namespace, job_id)]
            return sorted(versions, key=lambda j: -j.version)

    def update_job_stability(self, namespace: str, job_id: str,
                             version: int, stable: bool) -> int:
        """(reference :762) Mark one version (in place of the current
        job too, when it is that version) stable or not."""
        with self._lock:
            job = self._job_versions.get((namespace, job_id, version))
            if job is None:
                return self._index
            updated = copy.copy(job)
            updated.stable = stable
            updated.modify_index = self._index + 1
            self._job_versions[(namespace, job_id, version)] = updated
            current = self._jobs.get((namespace, job_id))
            if current is not None and current.version == version:
                self._jobs[(namespace, job_id)] = updated
            return self._bump("jobs", "job_versions")

    def update_job_status(self, namespace: str, job_id: str,
                          status: str) -> int:
        """A status-only write: no new job version (reference :720)."""
        with self._lock:
            existing = self._jobs.get((namespace, job_id))
            if existing is None:
                return self._index
            job = copy.copy(existing)
            job.status = status
            job.modify_index = self._index + 1
            self._jobs[(namespace, job_id)] = job
            self._job_versions[(namespace, job_id, job.version)] = job
            return self._bump("jobs")

    # -- scaling (reference :779-818) -----------------------------------
    def scaling_policies(self, namespace: Optional[str] = None) -> list:
        """Every policy, or a namespace's (None: every namespace)."""
        with self._lock:
            return [p for p in self._scaling_policies.values()
                    if namespace is None or p.namespace == namespace]

    def scaling_policy_by_id(self, policy_id: str):
        with self._lock:
            return self._scaling_policies.get(policy_id)

    def scaling_policies_by_job(self, namespace: str, job_id: str) -> list:
        with self._lock:
            return [p for p in self._scaling_policies.values()
                    if (p.namespace, p.job_id) == (namespace, job_id)]

    def upsert_scaling_event(self, namespace: str, job_id: str,
                             event: ScalingEvent) -> int:
        """Append to the job's scaling events, keeping the newest
        SCALING_EVENTS_KEPT."""
        with self._lock:
            events = self._scaling_events.setdefault((namespace, job_id), [])
            events.append(event)
            if len(events) > SCALING_EVENTS_KEPT:
                del events[:-SCALING_EVENTS_KEPT]
            return self._bump("scaling_events")

    def scaling_events_by_job(self, namespace: str, job_id: str) -> list:
        with self._lock:
            return list(self._scaling_events.get((namespace, job_id), []))

    def restore_from_snapshot(self, blob: dict) -> int:
        """(reference :1171) Replace every table with a dump_state blob
        in one write. The index becomes max(restored, prior), so it never
        goes back, and every table is bumped: the node-matrix cache
        (keyed by the node table's index) rebuilds, and the write's
        journal entry carries no delta, so a usage base or a resident
        chain across the restore refolds. A blob that does not decode
        raises before any table changes."""
        from .restore import restore_state
        with self._lock:
            prior = self._index
            restore_state(self, blob)
            self._index = max(self._index, prior)
            with statecheck.mark_uncoverable("snapshot restore"):
                return self._bump(*TABLES)

    def update_node_status(self, node_id: str, status: str,
                           updated_at: float = 0.0) -> int:
        """(reference :608) Raises KeyError for an unknown node."""
        with self._lock:
            old = self._nodes.get(node_id)
            if old is None:
                raise KeyError(f"node {node_id} not found")
            node = copy.copy(old)
            node.status = status
            node.status_updated_at = updated_at
            node.modify_index = self._index + 1
            self._nodes[node_id] = node
            return self._bump("nodes")

    def upsert_node_pool(self, pool: NodePool) -> int:
        with self._lock:
            existing = self._node_pools.get(pool.name)
            pool.create_index = (existing.create_index if existing
                                 else self._index + 1)
            pool.modify_index = self._index + 1
            self._node_pools[pool.name] = pool
            return self._bump("node_pools")

    def set_scheduler_config(self, cfg: SchedulerConfiguration) -> int:
        with self._lock:
            cfg.modify_index = self._index + 1
            self._scheduler_config = cfg
            return self._bump("scheduler_config")

    def upsert_evals(self, evals: Iterable) -> int:
        """Insert or replace evaluations (keyed by ``ev.id``)."""
        now = time.time()
        with self._lock:
            for ev in evals:
                existing = self._evals.get(ev.id)
                if existing is not None:
                    ev.create_index = existing.create_index
                    ev.create_time = existing.create_time
                else:
                    ev.create_index = self._index + 1
                    ev.create_time = now
                ev.modify_index = self._index + 1
                ev.modify_time = now
                self._evals[ev.id] = ev
            return self._bump("evals")

    def delete_evals(self, eval_ids: Iterable[str]) -> int:
        """(reference :833)"""
        with self._lock:
            for eid in eval_ids:
                self._evals.pop(eid, None)
            return self._bump("evals")

    def upsert_allocs(self, allocs: Iterable) -> int:
        """Insert or replace allocations (keyed by ``alloc.id``); the
        write journals one (existing | None, alloc) pair per alloc."""
        with self._lock:
            pairs = self._insert_allocs_locked(allocs)
            return self._bump("allocs", delta=pairs)

    def _insert_allocs_locked(self, allocs: Iterable) -> List[tuple]:
        """Insert or replace ``allocs`` and index them; returns the
        write's (existing | None, alloc) pairs. No index bump here."""
        now = time.time()
        allocs = list(allocs)
        pairs: List[tuple] = []
        for alloc in allocs:
            existing = self._allocs.get(alloc.id)
            if hasattr(alloc, "modify_index"):
                if existing is not None:
                    alloc.create_index = existing.create_index
                    alloc.create_time = existing.create_time
                else:
                    alloc.create_index = self._index + 1
                    alloc.create_time = now
                alloc.modify_index = self._index + 1
                alloc.modify_time = now
                if alloc.job is None and existing is not None:
                    alloc.job = existing.job
            pairs.append((existing, alloc))
            self._allocs[alloc.id] = alloc
            self._allocs_by_node.setdefault(
                alloc.node_id, {})[alloc.id] = None
            self._allocs_by_job.setdefault(
                _job_key(alloc), {})[alloc.id] = None
        self.alloc_table.upsert_many(_table_rows(allocs))
        return pairs

    def update_allocs_from_client(self, allocs: Iterable) -> int:
        """Client status updates (reference :877; upstream: state
        UpdateAllocsFromClient): each known alloc takes the update's
        client status, description, task states, network status,
        deployment status and terminal time, in a new copy; the write
        journals one (stored, updated) pair per alloc. Unknown ids are
        skipped."""
        with self._lock:
            pairs = []
            now = time.time()
            for updated in allocs:
                existing = self._allocs.get(updated.id)
                if existing is None:
                    continue
                alloc = copy.copy(existing)
                alloc.client_status = updated.client_status
                alloc.client_description = updated.client_description
                alloc.task_states = dict(updated.task_states)
                alloc.network_status = updated.network_status
                if updated.deployment_status is not None:
                    alloc.deployment_status = updated.deployment_status
                if updated.client_terminal_time:
                    alloc.client_terminal_time = updated.client_terminal_time
                alloc.modify_index = self._index + 1
                alloc.modify_time = now
                self._allocs[alloc.id] = alloc
                pairs.append((existing, alloc))
                self.alloc_table.upsert(alloc)
            return self._bump("allocs", delta=pairs)

    def update_alloc_desired_transition(self, alloc_ids: Iterable[str],
                                        migrate: bool = True) -> int:
        """(reference :904) The drainer's migration request: each known
        alloc gets a DesiredTransition in a new copy, one write. Its
        liveness does not change, so its table row stays."""
        with self._lock:
            pairs = []
            for aid in alloc_ids:
                existing = self._allocs.get(aid)
                if existing is None:
                    continue
                alloc = copy.copy(existing)
                alloc.desired_transition = DesiredTransition(migrate=migrate)
                alloc.modify_index = self._index + 1
                self._allocs[aid] = alloc
                pairs.append((existing, alloc))
            return self._bump("allocs", delta=pairs)

    def quality_usage_by_node(self) -> Dict[str, tuple]:
        """(reference :1559) Per-node-id live (cpu, mem, disk) under the
        scheduler's liveness filter, from the alloc table's fold columns
        under the store lock: an accounting independent of the quality
        observatory's delta-kept one, for its parity checks."""
        with self._lock:
            return self.alloc_table.usage_by_node()

    def preallocate_allocs(self, capacity: int) -> None:
        """(reference :1568) Grow the alloc table to ``capacity`` rows
        ahead of a large write, under the store lock."""
        with self._lock:
            self.alloc_table.preallocate(capacity)

    def compact_alloc_table(self, min_free: int = 4096,
                            free_ratio: float = 0.5):
        """(reference :1577) Compact the alloc table once its free rows
        exceed both ``min_free`` and ``free_ratio`` of its rows. Returns
        the compaction's stats, or None below that mark."""
        with self._lock:
            t = self.alloc_table
            if t.free_rows < min_free or \
                    t.free_rows < free_ratio * max(1, t.n_rows):
                return None
            return t.compact()

    def upsert_deployment(self, deployment) -> int:
        """Insert or replace a deployment (keyed by ``deployment.id``)."""
        with self._lock:
            self._upsert_deployment_locked(deployment)
            return self._bump("deployments")

    def upsert_deployment_cas(self, deployment,
                              expected_modify_index: int) -> bool:
        """(reference :948) Commit only while the stored deployment's
        modify index is ``expected_modify_index``: the watcher's guard
        against a plan commit that advanced it meanwhile."""
        with self._lock:
            existing = self._deployments.get(deployment.id)
            if existing is not None and \
                    existing.modify_index != expected_modify_index:
                return False
            self._upsert_deployment_locked(deployment)
            self._bump("deployments")
            return True

    def delete_deployment(self, deployment_id: str) -> int:
        with self._lock:
            self._deployments.pop(deployment_id, None)
            return self._bump("deployments")

    def _upsert_deployment_locked(self, deployment) -> None:
        existing = self._deployments.get(deployment.id)
        if existing is not None:
            deployment.create_index = existing.create_index
        else:
            deployment.create_index = self._index + 1
        deployment.modify_index = self._index + 1
        self._deployments[deployment.id] = deployment

    def _stage_plan_result_locked(self, result, eval_updates=None):
        """One plan result's dict and object writes (reference :1413):
        each stop and preemption is merged onto a copy of the stored
        alloc (desired status and description, preempting alloc, client
        status and follow-up eval where set), the plan's deployment and
        its status updates land, and ``eval_updates`` replace their
        evals. The alloc table and the secondary indexes are the
        caller's, batched across plans. Returns (merged stops,
        placements, change pairs). Lock held; no index bump."""
        idx = self._index + 1
        merged: List[object] = []
        pairs: List[tuple] = []
        for group in (result.node_update, result.node_preemptions):
            for allocs in group.values():
                for stop in allocs:
                    existing = self._allocs.get(stop.id)
                    if existing is None:
                        continue
                    alloc = copy.copy(existing)
                    alloc.desired_status = stop.desired_status
                    alloc.desired_description = stop.desired_description
                    alloc.preempted_by_allocation = \
                        stop.preempted_by_allocation
                    if stop.client_status:
                        alloc.client_status = stop.client_status
                    if stop.followup_eval_id:
                        alloc.followup_eval_id = stop.followup_eval_id
                    alloc.modify_index = idx
                    alloc.modify_time = time.time()
                    self._allocs[alloc.id] = alloc
                    merged.append(alloc)
                    pairs.append((existing, alloc))
        if result.deployment is not None:
            self._upsert_deployment_locked(result.deployment)
        for du in result.deployment_updates:
            d = self._deployments.get(du.deployment_id)
            if d is not None:
                nd = copy.copy(d)
                nd.status = du.status
                nd.status_description = du.status_description
                nd.modify_index = idx
                self._deployments[nd.id] = nd
        for ev in eval_updates or ():
            ev.modify_index = idx
            self._evals[ev.id] = ev
        placements = [a for allocs in result.node_allocation.values()
                      for a in allocs]
        return merged, placements, pairs

    def upsert_plan_results(self, result, eval_updates=None) -> int:
        """Commit a plan result in one logical write (reference :1479;
        upstream: state_store.go UpsertPlanResults): the staged stops
        refresh their alloc-table rows (a plan-committed stop is
        server-terminal at once, so the applier's liveness flips with
        it), then the placements are inserted. The write journals the
        merged stops' and the placements' (old, new) pairs, as
        upsert_allocs does, so a usage base catches up across it. Sets
        and returns ``result.alloc_index``."""
        with self._lock:
            merged, placements, pairs = self._stage_plan_result_locked(
                result, eval_updates)
            self.alloc_table.upsert_many(_table_rows(merged))
            pairs.extend(self._insert_allocs_locked(placements))
            idx = self._bump("allocs", "deployments", "evals", delta=pairs)
            result.alloc_index = idx
            return idx

    def apply_plan_results_batch(self, entries) -> Tuple[int, list]:
        """Group commit (reference :1507): ``entries`` of (PlanResult,
        eval updates) land as ONE transaction -- one lock acquisition,
        one index bump, one alloc-table pass for the whole group's stops
        and placements. The ``plan.commit`` fault point fires before
        each entry's writes; an entry that raises is skipped (the group
        splits around it) and its exception rides the returned outcome
        list (None = committed). Returns (index, outcomes)."""
        if schedcheck._ACTIVE:
            # a batch commit is the write-skew decision point
            schedcheck.yield_point("store.apply_batch")
        with self._lock:
            outcomes: list = []
            merged_all: list = []
            placements_all: list = []
            pairs_all: list = []
            staged: list = []
            for result, eval_updates in entries:
                try:
                    faults.fire("plan.commit")
                    merged, placements, pairs = \
                        self._stage_plan_result_locked(result, eval_updates)
                except BaseException as e:  # noqa: BLE001 -- split
                    outcomes.append(e)
                    continue
                merged_all.extend(merged)
                placements_all.extend(placements)
                pairs_all.extend(pairs)
                staged.append(result)
                outcomes.append(None)
            self.alloc_table.upsert_many(_table_rows(merged_all))
            pairs_all.extend(self._insert_allocs_locked(placements_all))
            idx = self._bump("allocs", "deployments", "evals",
                             delta=pairs_all)
            for result in staged:
                result.alloc_index = idx
            return idx, outcomes

    def delete_allocs(self, alloc_ids: Iterable[str]) -> int:
        """Remove allocations; journals (alloc, None) per removed one."""
        with self._lock:
            pairs = []
            for aid in alloc_ids:
                a = self._allocs.pop(aid, None)
                if a is not None:
                    pairs.append((a, None))
                    self._allocs_by_node.get(a.node_id, {}).pop(aid, None)
                    self._allocs_by_job.get(_job_key(a), {}).pop(aid, None)
                self.alloc_table.remove(aid)
            return self._bump("allocs", delta=pairs)

    def replace_allocs(self, allocs: Iterable) -> int:
        """Replace the whole alloc table at once, as a snapshot restore
        does: no change-pair set exists, so the write journals an
        explicit coverage gap (delta None)."""
        with self._lock:
            for aid in self._allocs:
                self.alloc_table.remove(aid)
            allocs = list(allocs)
            self._allocs = {}
            self._allocs_by_node = {}
            self._allocs_by_job = {}
            for a in allocs:
                self._allocs[a.id] = a
                self._allocs_by_node.setdefault(a.node_id, {})[a.id] = None
                self._allocs_by_job.setdefault(_job_key(a), {})[a.id] = None
            self.alloc_table.upsert_many(_table_rows(allocs))
            with statecheck.mark_uncoverable("replace_allocs"):
                return self._bump("allocs")

    # -- reads: the scheduler reads a snapshot --------------------------
    def allocs(self) -> list:
        with self._lock:
            return list(self._allocs.values())

    def allocs_by_job(self, namespace: str, job_id: str) -> list:
        """The job's allocs in the job index's order (the reference reads
        the live index; a snapshot per call would copy every index
        whenever the store moved, which the leader's loops call for per
        deployment and job)."""
        with self._lock:
            return [self._allocs[i]
                    for i in self._allocs_by_job.get((namespace, job_id), ())
                    if i in self._allocs]

    def eval_by_id(self, eval_id: str):
        with self._lock:
            return self._evals.get(eval_id)

    def allocs_by_eval(self, eval_id: str) -> list:
        with self._lock:
            return [a for a in self._allocs.values() if a.eval_id == eval_id]

    def allocs_by_node_terminal(self, node_id: str, terminal: bool) -> list:
        return [a for a in self.allocs_by_node(node_id)
                if a.terminal_status() == terminal]

    def deployments(self) -> list:
        with self._lock:
            return list(self._deployments.values())

    def evals(self) -> list:
        with self._lock:
            return list(self._evals.values())

    def deployment_by_id(self, deployment_id: str):
        with self._lock:
            return self._deployments.get(deployment_id)

    def latest_deployment_by_job(self, namespace: str, job_id: str):
        return self.snapshot().latest_deployment_by_job(namespace, job_id)

    def scheduler_config(self) -> SchedulerConfiguration:
        with self._lock:
            return self._scheduler_config

    def evals_by_job(self, namespace: str, job_id: str) -> list:
        with self._lock:
            return [e for e in self._evals.values()
                    if e.namespace == namespace and e.job_id == job_id]

    def node_by_id(self, node_id: str):
        with self._lock:
            return self._nodes.get(node_id)

    def nodes(self) -> list:
        with self._lock:
            return list(self._nodes.values())

    def job_by_id(self, namespace: str, job_id: str):
        with self._lock:
            return self._jobs.get((namespace, job_id))

    def jobs(self) -> list:
        with self._lock:
            return list(self._jobs.values())

    def alloc_by_id(self, alloc_id: str):
        with self._lock:
            return self._allocs.get(alloc_id)

    def allocs_by_node(self, node_id: str) -> list:
        with self._lock:
            return [self._allocs[i]
                    for i in self._allocs_by_node.get(node_id, ())
                    if i in self._allocs]

    def namespace_by_name(self, name: str):
        with self._lock:
            return self._namespaces.get(name)

    def node_pool_by_name(self, name: str):
        with self._lock:
            return self._node_pools.get(name)
