"""Carry state of the JAX package over into the port.

``lane_from_reference`` takes the reference's lane tables -- NamedTuples
of numpy arrays (NodeConst, NodeState, PlacementBatch) and the shuffle
order -- reads them field by field, and builds the port's PackedLane, so
that both packages solve the same inputs: the dense lanes'
distinct_property, device and reserved-core tables and a preemption
lane's PreemptTables / PreemptState ride along by name.

``struct_from_reference`` maps a reference struct (a dataclass, and the
lists, dicts, sets and scalars it holds) onto the port struct of the
same class name, field by field; ``store_from_reference`` builds a port
StateStore holding a reference snapshot's nodes, jobs, allocations,
namespaces, node pools, job versions, scheduler configuration, scaling
policies and scaling events, at the snapshot's index, with the alloc
table rebuilt from them.

Everything here reads attributes by name and imports nothing of the
reference.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np

from .device import DeviceLike, default_dtype_name
from .solver.binpack import (
    NodeConst, NodeState, PlacementBatch, PreemptState, PreemptTables)
from .solver.service import PackedLane


def _read(cls, src, dtype):
    """Build ``cls`` from the same-named fields of ``src``; floating fields
    are cast to the lane dtype (the reference casts them at pack time)."""
    vals = {}
    for name in cls._fields:
        if not hasattr(src, name):
            continue                    # trailing defaults stay 0-size
        arr = np.asarray(getattr(src, name))
        if np.issubdtype(arr.dtype, np.floating):
            arr = arr.astype(dtype)
        vals[name] = arr
    return cls(**vals)


def lane_from_reference(const, init, batch, order, *,
                        dtype_name: Optional[str] = None,
                        spread_alg: bool = False,
                        node_ids: Optional[Sequence[str]] = None,
                        ptab=None, pinit=None, matrix=None,
                        plan_priority: int = 50,
                        plan_has_stops: bool = False,
                        table_version: Optional[int] = None,
                        delta_src=None,
                        device: DeviceLike = None) -> PackedLane:
    """The port's PackedLane for a reference lane's tables; a preemption
    lane passes its ``ptab`` and ``pinit`` too. ``matrix`` (a port
    NodeMatrix), ``plan_priority`` and ``plan_has_stops`` carry what the
    LP tier and the cross-lane fixpoint read; ``table_version`` and
    ``delta_src`` (the reference lane's own, a (store, index) pair) what
    the resident buffer set reads. ``dtype_name`` defaults by ``device``
    (float64 on the CPU, float32 on the card)."""
    dtype_name = default_dtype_name(device, dtype_name)
    dt = np.dtype(dtype_name)
    pc = _read(NodeConst, const, dt)
    if pc.dev_aff.size == 0 and hasattr(const, "dev_sum_weight"):
        # with no device asks the packer leaves dev_sum_weight at its
        # float32 default whatever the lane dtype (make_node_const)
        pc = pc._replace(dev_sum_weight=np.asarray(const.dev_sum_weight))
    return PackedLane(
        np.asarray(order, dtype=np.int64),
        pc, _read(NodeState, init, dt),
        _read(PlacementBatch, batch, dt), dtype_name, bool(spread_alg),
        node_ids=node_ids,
        ptab=None if ptab is None else _read(PreemptTables, ptab, dt),
        pinit=None if pinit is None else _read(PreemptState, pinit, dt),
        matrix=matrix, plan_priority=plan_priority,
        plan_has_stops=plan_has_stops, table_version=table_version,
        delta_src=delta_src)


def _port_classes() -> Dict[str, type]:
    """Every dataclass of the port's structs by class name, with the
    placement ask."""
    from . import structs
    from .scheduler.reconcile import AllocPlaceResult
    from .structs import alloc, config, job, network, node, resources
    out: Dict[str, type] = {}
    for mod in (resources, network, node, job, alloc, config, structs):
        for name, val in vars(mod).items():
            if isinstance(val, type) and dataclasses.is_dataclass(val):
                out[name] = val
    out["AllocPlaceResult"] = AllocPlaceResult
    return out


_SCALARS = (type(None), bool, int, float, complex, str, bytes)


def struct_from_reference(obj, memo: Optional[dict] = None,
                          classes: Optional[Dict[str, type]] = None):
    """The port struct for a reference struct: each dataclass instance
    becomes an instance of the class of the same name in ``classes``
    (default: the port's structs), field by field; lists, tuples,
    dicts, sets and frozensets are rebuilt around their carried items;
    scalars pass as they are. An object seen before (``memo``, keyed by
    ``id()``; pass one dict to several calls to share it) maps to the
    same carried object, so what the source shares stays shared. An
    object that defers its content (``__nomad_hydrate__``) is carried
    as what it hydrates to. Raises TypeError for a class ``classes``
    lacks."""
    if memo is None:
        memo = {}
    if classes is None:
        classes = _port_classes()
    return _carry(obj, memo, classes)


def _carry(obj, memo: dict, classes: Dict[str, type]):
    if isinstance(obj, _SCALARS):
        return obj
    hit = memo.get(id(obj))
    if hit is not None:
        return hit[1]
    if isinstance(obj, list):
        out = []
        memo[id(obj)] = (obj, out)
        out.extend(_carry(x, memo, classes) for x in obj)
        return out
    if isinstance(obj, dict):
        out = {}
        memo[id(obj)] = (obj, out)
        for k, v in obj.items():
            out[_carry(k, memo, classes)] = _carry(v, memo, classes)
        return out
    if isinstance(obj, (tuple, set, frozenset)):
        out = type(obj)(_carry(x, memo, classes) for x in obj)
        memo[id(obj)] = (obj, out)
        return out
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = classes.get(type(obj).__name__)
        if cls is None:
            raise TypeError(f"no port struct named {type(obj).__name__}")
        out = cls.__new__(cls)
        memo[id(obj)] = (obj, out)
        for f in dataclasses.fields(cls):
            if hasattr(obj, f.name):
                val = _carry(getattr(obj, f.name), memo, classes)
            elif f.default is not dataclasses.MISSING:
                val = f.default
            elif f.default_factory is not dataclasses.MISSING:
                val = f.default_factory()
            else:
                raise TypeError(f"{type(obj).__name__} lacks {f.name}")
            object.__setattr__(out, f.name, val)
        return out
    hydrate = getattr(obj, "__nomad_hydrate__", None)
    if hydrate is not None:
        out = _carry(hydrate(), memo, classes)
        memo[id(obj)] = (obj, out)
        return out
    raise TypeError(f"cannot carry a {type(obj).__name__}")


def store_from_reference(snapshot, memo: Optional[dict] = None):
    """A port StateStore holding what a reference snapshot (or live
    store) holds: its nodes, jobs, evaluations, allocations and
    deployments in the snapshot's order (each node's and each job's
    allocations in the order the snapshot lists them), its namespaces,
    node pools, scaling policies and scaling events, service catalog and
    ACL tables (a snapshot's are read from its live store), and its
    scheduler configuration; at the
    snapshot's latest_index() and
    node-table index, with an empty journal and the alloc table rebuilt
    (nodes registered in the snapshot's order, then the allocations).
    ``memo`` is struct_from_reference's."""
    from .state.store import StateStore

    if memo is None:
        memo = {}
    classes = _port_classes()

    def carry(x):
        return _carry(x, memo, classes)

    store = StateStore()
    index = int(snapshot.latest_index())
    node_index = getattr(snapshot, "node_table_index", None)
    if node_index is None:
        node_index = snapshot.table_index("nodes")
    with store._lock:
        for n in snapshot.nodes():
            store._nodes[n.id] = carry(n)
        for j in snapshot.jobs():
            store._jobs[(j.namespace, j.id)] = carry(j)
        # the stored versions of each job live on the reference's store
        live = getattr(snapshot, "_store", snapshot)
        versions = getattr(live, "_job_versions", None)
        if versions is None:
            versions = {(j.namespace, j.id, j.version): j
                        for j in snapshot.jobs()}
        for key, j in list(versions.items()):
            store._job_versions[key] = carry(j)
        # a reference snapshot lists its evals only as a table
        evals = (snapshot.evals() if hasattr(snapshot, "evals")
                 else list(getattr(snapshot, "_evals", {}).values()))
        for ev in evals:
            store._evals[ev.id] = carry(ev)
        for d in snapshot.deployments():
            store._deployments[d.id] = carry(d)
        allocs = snapshot.allocs()
        for a in allocs:
            store._allocs[a.id] = carry(a)
        for nid in store._nodes:
            ids = [a.id for a in snapshot.allocs_by_node(nid)]
            if ids:
                store._allocs_by_node[nid] = dict.fromkeys(ids)
        for key in store._jobs:
            ids = [a.id for a in snapshot.allocs_by_job(*key)]
            if ids:
                store._allocs_by_job[key] = dict.fromkeys(ids)
        for a in allocs:
            store._allocs_by_node.setdefault(a.node_id, {}).setdefault(a.id)
            store._allocs_by_job.setdefault(
                (a.namespace, a.job_id), {}).setdefault(a.id)
        for ns in getattr(live, "namespaces", list)():
            store._namespaces[ns.name] = carry(ns)
        for pool in getattr(live, "node_pools", list)():
            store._node_pools[pool.name] = carry(pool)
        for pid, pol in getattr(live, "_scaling_policies", {}).items():
            store._scaling_policies[pid] = carry(pol)
        for key, events in getattr(live, "_scaling_events", {}).items():
            store._scaling_events[key] = [carry(e) for e in events]
        for rid, reg in getattr(live, "_services", {}).items():
            store._services[rid] = carry(reg)
        for name, pol in getattr(live, "_acl_policies", {}).items():
            store._acl_policies[name] = carry(pol)
        for name, role in getattr(live, "_acl_roles", {}).items():
            store._acl_roles[name] = carry(role)
        for acc, tok in getattr(live, "_acl_tokens", {}).items():
            store._acl_tokens[acc] = carry(tok)
            store._acl_tokens_by_secret[tok.secret_id] = acc
        store._acl_bootstrapped = bool(getattr(live, "_acl_bootstrapped",
                                               False))
        for n in store._nodes.values():
            store.alloc_table.register_node(n)
        store.alloc_table.upsert_many(list(store._allocs.values()))
        store._scheduler_config = carry(snapshot.scheduler_config())
        store._index = index
        store._table_index = {"nodes": int(node_index), "allocs": index,
                              "jobs": index, "evals": index,
                              "deployments": index,
                              "scheduler_config": index,
                              "scaling_policies": index,
                              "scaling_events": index}
        live_index = getattr(live, "_table_index", {})
        for t in ("namespaces", "node_pools", "services", "acl_policies",
                  "acl_roles", "acl_tokens"):
            if t in live_index:
                store._table_index[t] = min(int(live_index[t]), index)
    return store
