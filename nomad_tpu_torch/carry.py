"""Carry a lane packed by the JAX package over into the port.

``lane_from_reference`` takes the reference's lane tables -- NamedTuples
of numpy arrays (NodeConst, NodeState, PlacementBatch) and the shuffle
order -- reads them field by field, and builds the port's PackedLane, so
that both packages solve the same inputs: the dense lanes'
distinct_property, device and reserved-core tables and a preemption
lane's PreemptTables / PreemptState ride along by name.
It takes plain arrays and imports nothing of the reference.
"""
from __future__ import annotations

from typing import Optional, Sequence

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
