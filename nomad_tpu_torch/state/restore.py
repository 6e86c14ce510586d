"""Whole-store dump and restore (port of nomad_tpu/raft/fsm.py:199
``dump_state`` and nomad_tpu/state/restore.py:28 ``restore_state``; the
port has no raft layer, so both live beside the store they read and
write).

``dump_state(store)`` is a JSON-able blob of every table the port's
store keeps: nodes, jobs, job versions, evals, allocs, deployments, node
pools, namespaces, the scheduler configuration, scaling policies and
scaling events, with the index and each table's index. Keys and layout
are the reference's (structs through structs/codec.py, tuple keys joined
by ``\\x1f``), so a blob the reference dumps restores here and a blob
dumped here restores in the reference (which reads its other tables as
empty). An alloc's job is encoded in full, as the reference writes it;
the allocs of one job version share one encoding.

``restore_state(store, blob)`` decodes everything first, so a blob that
does not decode raises before any table changes; then it replaces every
table, rebuilds the secondary indexes, links each alloc's job back to
the stored job of the same version (an alloc's job of the stored
version is not decoded at all: the link would replace it), drops the
snapshot cache, and rebuilds the alloc table from the allocs that are
not client-terminal (a server-terminal alloc the client still runs keeps
its capacity until the client acknowledges it). The index and the table
indexes are the blob's; ``StateStore.restore_from_snapshot`` is the
write that keeps the index monotonic and marks the journal.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

from ..structs import (
    Allocation, Deployment, Evaluation, Job, Namespace, Node, NodePool,
    ScalingEvent, ScalingPolicy, SchedulerConfiguration, codec)
from .alloc_table import AllocTable
from .store import TABLES

if TYPE_CHECKING:  # pragma: no cover
    from .store import StateStore

_ALLOC_FIELDS = tuple(f.name for f in dataclasses.fields(Allocation))


def _encode_alloc(alloc, jobs: dict) -> dict:
    """codec.encode(alloc), the job's encoding shared by every alloc of
    the same Job object (``jobs``: id(job) -> its encoding)."""
    out = {}
    for name in _ALLOC_FIELDS:
        if name != "job":
            out[name] = codec.encode(getattr(alloc, name))
            continue
        job = alloc.job
        if job is None:
            out[name] = None
            continue
        enc = jobs.get(id(job))
        if enc is None:
            enc = jobs[id(job)] = codec.encode(job)
        out[name] = enc
    return out


def dump_state(store: "StateStore") -> dict:
    """Every table of ``store`` as one JSON-able blob. The tables are
    read at one point in time under the store's lock (their dicts
    copied: the store replaces a stored struct, never changes it, as
    StateSnapshot relies on too); the encoding runs after the lock is
    released, so writers wait for the copy only."""
    with store._lock:
        index = store._index
        table_index = {t: store._table_index.get(t, 1) for t in TABLES}
        nodes = list(store._nodes.values())
        jobs = list(store._jobs.values())
        job_versions = list(store._job_versions.items())
        evals = list(store._evals.values())
        allocs = list(store._allocs.values())
        deployments = list(store._deployments.values())
        pools = list(store._node_pools.values())
        sched_cfg = store._scheduler_config
        policies = list(store._scaling_policies.values())
        events = [(k, list(evs))
                  for k, evs in store._scaling_events.items()]
        namespaces = list(store._namespaces.values())
    job_encodings: dict = {}
    return {
        "index": index,
        "table_index": table_index,
        "nodes": [codec.encode(n) for n in nodes],
        "jobs": [codec.encode(j) for j in jobs],
        "job_versions": {codec._encode_key(k): codec.encode(v)
                         for k, v in job_versions},
        "evals": [codec.encode(e) for e in evals],
        "allocs": [_encode_alloc(a, job_encodings) for a in allocs],
        "deployments": [codec.encode(d) for d in deployments],
        "node_pools": [codec.encode(p) for p in pools],
        "scheduler_config": codec.encode(sched_cfg),
        "scaling_policies": [codec.encode(p) for p in policies],
        "scaling_events": {codec._encode_key(k): [codec.encode(e)
                                                  for e in evs]
                           for k, evs in events},
        "namespaces": [codec.encode(n) for n in namespaces],
    }


def _decode_allocs(raws, jobs: dict) -> list:
    """The allocs of a blob, each job linked to the stored job of its
    (namespace, job id) where the versions agree (``jobs``: the decoded
    job table), else decoded from the alloc's own copy."""
    out = []
    for raw in raws:
        body = {k: v for k, v in raw.items() if k != "job"}
        alloc = codec.decode(Allocation, body)
        raw_job = raw.get("job")
        if raw_job is not None:
            stored = jobs.get((alloc.namespace, alloc.job_id))
            if stored is not None and \
                    raw_job.get("version", 0) == stored.version:
                alloc.job = stored
            else:
                alloc.job = codec.decode(Job, raw_job)
        out.append(alloc)
    return out


def restore_state(store: "StateStore", blob: dict) -> None:
    """Replace every table of ``store`` with ``blob``'s (decoded in full
    before the store is touched)."""
    nodes = [codec.decode(Node, n) for n in blob.get("nodes", [])]
    jobs = [codec.decode(Job, j) for j in blob.get("jobs", [])]
    job_table = {(j.namespace, j.id): j for j in jobs}
    evals = [codec.decode(Evaluation, e) for e in blob.get("evals", [])]
    allocs = _decode_allocs(blob.get("allocs", []), job_table)
    deployments = [codec.decode(Deployment, d)
                   for d in blob.get("deployments", [])]
    pools = [codec.decode(NodePool, p) for p in blob.get("node_pools", [])]
    sched_cfg = codec.decode(SchedulerConfiguration,
                             blob.get("scheduler_config") or {})
    job_versions = {}
    for k, v in blob.get("job_versions", {}).items():
        ns, jid, ver = k.split("\x1f")
        job_versions[(ns, jid, int(ver))] = codec.decode(Job, v)
    scaling_policies = {
        pol.id: pol for pol in
        (codec.decode(ScalingPolicy, raw)
         for raw in blob.get("scaling_policies", []))}
    scaling_events = {}
    for k, evs in blob.get("scaling_events", {}).items():
        ns, jid = k.split("\x1f")
        scaling_events[(ns, jid)] = [
            codec.decode(ScalingEvent, e) for e in evs]
    namespaces = {n.name: n for n in
                  (codec.decode(Namespace, raw)
                   for raw in blob.get("namespaces", []))}
    namespaces.setdefault("default", Namespace(name="default"))
    table = AllocTable()
    for n in nodes:
        table.register_node(n)
    table.upsert_many([a for a in allocs
                       if not a.client_terminal_status()])
    index = blob.get("index", 1)
    table_index = blob.get("table_index", {})
    with store._lock:
        store._nodes = {n.id: n for n in nodes}
        store._jobs = job_table
        store._job_versions = job_versions
        store._evals = {e.id: e for e in evals}
        store._allocs = {a.id: a for a in allocs}
        store._deployments = {d.id: d for d in deployments}
        store._node_pools = {p.name: p for p in pools}
        if sched_cfg is not None:
            store._scheduler_config = sched_cfg
        store._allocs_by_node = {}
        store._allocs_by_job = {}
        for a in allocs:
            store._allocs_by_node.setdefault(a.node_id, {})[a.id] = None
            store._allocs_by_job.setdefault(
                (a.namespace, a.job_id), {})[a.id] = None
        store._snap_cache = None
        store._scaling_policies = scaling_policies
        store._scaling_events = scaling_events
        store._namespaces = namespaces
        store._index = index
        store._table_index = {t: table_index.get(t, index) for t in TABLES}
        store.alloc_table = table
        store._watch_cond.notify_all()
