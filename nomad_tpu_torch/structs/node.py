"""Node model (port of nomad_tpu/structs/node.py; upstream:
nomad/structs/structs.go Node, structs/node_class.go ComputeClass,
structs/node_pool.go NodePool). ``compute_class`` hashes the same bytes
as the reference's (BLAKE2b-8), so class codes agree across packages."""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .resources import NodeReservedResources, NodeResources

NODE_STATUS_INIT = "initializing"
NODE_STATUS_READY = "ready"
NODE_STATUS_DOWN = "down"
NODE_STATUS_DISCONNECTED = "disconnected"

NODE_SCHED_ELIGIBLE = "eligible"
NODE_SCHED_INELIGIBLE = "ineligible"


@dataclass
class DrainStrategy:
    """Node drain spec (reference: structs.DrainStrategy)."""

    deadline_s: float = 3600.0
    ignore_system_jobs: bool = False
    force_deadline: float = 0.0   # absolute unix time; 0 = unset
    started_at: float = 0.0


@dataclass
class NodePool:
    """Grouping of nodes with optional scheduler-config override
    (reference: structs/node_pool.go)."""

    name: str = "default"
    description: str = ""
    meta: Dict[str, str] = field(default_factory=dict)
    scheduler_algorithm: str = ""   # "" = inherit global
    create_index: int = 0
    modify_index: int = 0


@dataclass
class Node:
    """A fleet member (reference: structs.Node)."""

    id: str = ""
    name: str = ""
    datacenter: str = "dc1"
    node_pool: str = "default"
    node_class: str = ""
    attributes: Dict[str, str] = field(default_factory=dict)
    meta: Dict[str, str] = field(default_factory=dict)
    node_resources: NodeResources = field(default_factory=NodeResources)
    reserved_resources: NodeReservedResources = field(default_factory=NodeReservedResources)
    links: Dict[str, str] = field(default_factory=dict)
    status: str = NODE_STATUS_INIT
    status_description: str = ""
    status_updated_at: float = 0.0
    scheduling_eligibility: str = NODE_SCHED_ELIGIBLE
    drain_strategy: Optional[DrainStrategy] = None
    drivers: Dict[str, "DriverInfo"] = field(default_factory=dict)
    host_volumes: Dict[str, "ClientHostVolumeConfig"] = field(default_factory=dict)
    csi_node_plugins: Dict[str, dict] = field(default_factory=dict)
    last_drain: Optional[dict] = None
    events: List[dict] = field(default_factory=list)
    create_index: int = 0
    modify_index: int = 0
    # computed class cache (see computed_class())
    computed_class: str = ""

    def ready(self) -> bool:
        return (self.status == NODE_STATUS_READY
                and self.drain_strategy is None
                and self.scheduling_eligibility == NODE_SCHED_ELIGIBLE)

    @property
    def drain(self) -> bool:
        return self.drain_strategy is not None

    def terminal_status(self) -> bool:
        return self.status == NODE_STATUS_DOWN

    def compute_class(self) -> str:
        """Hash the scheduling-relevant fields into an equivalence class used
        to memoize feasibility (reference: structs/node_class.go
        Node.ComputeClass). Nodes with identical classes pass/fail the same
        class-level constraint checks."""
        h = hashlib.blake2b(digest_size=8)
        h.update(self.datacenter.encode())
        h.update(self.node_class.encode())
        h.update(self.node_pool.encode())
        for k in sorted(self.attributes):
            if k.startswith("unique."):
                continue
            h.update(k.encode())
            h.update(str(self.attributes[k]).encode())
        for k in sorted(self.meta):
            if k.startswith("unique."):
                continue
            h.update(k.encode())
            h.update(str(self.meta[k]).encode())
        for dname in sorted(self.drivers):
            di = self.drivers[dname]
            h.update(dname.encode())
            h.update(b"1" if di.detected else b"0")
            h.update(b"1" if di.healthy else b"0")
        for d in self.node_resources.devices:
            h.update(d.id_string().encode())
        self.computed_class = h.hexdigest()
        return self.computed_class


@dataclass
class DriverInfo:
    detected: bool = False
    healthy: bool = False
    health_description: str = ""
    attributes: Dict[str, str] = field(default_factory=dict)


@dataclass
class ClientHostVolumeConfig:
    name: str = ""
    path: str = ""
    read_only: bool = False
