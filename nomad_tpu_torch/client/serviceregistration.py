"""Workload service registration: the catalog entries of an alloc's
group and task services (port of nomad_tpu/client/serviceregistration.py;
upstream: client/serviceregistration/, the "nomad" provider's nsd/).
When a workload starts, its services with provider "nomad" enter the
server's native catalog; they leave it when the alloc stops. The address
is the node's, the port the alloc's port of the service's label
(upstream: serviceregistration/workload.go).
"""
from __future__ import annotations

from typing import List

from ..structs import Allocation, Node, ServiceRegistration


def _node_address(node: Node) -> str:
    for key in ("unique.network.ip-address", "network.ip-address"):
        addr = (node.attributes or {}).get(key)
        if addr:
            return addr
    return "127.0.0.1"


def _port_by_label(alloc: Allocation, label: str) -> int:
    """A service's port label resolved against the alloc's assigned
    ports (upstream: taskenv's port interpolation over AllocatedPorts)."""
    if not label:
        return 0
    res = alloc.allocated_resources
    networks = []
    if res is not None:
        # group network ports land in shared.ports (AllocatedPortMapping)
        for pm in res.shared.ports or []:
            if pm.label == label:
                return pm.value
        networks.extend(res.shared.networks or [])
        for tr in res.tasks.values():
            networks.extend(tr.networks or [])
    for net in networks:
        for port in list(net.reserved_ports or []) + \
                list(net.dynamic_ports or []):
            if port.label == label:
                return port.value
    return 0


def build_registrations(alloc: Allocation, node: Node
                        ) -> List[ServiceRegistration]:
    """The registrations of every provider="nomad" service of the
    alloc's group and tasks. Ids derive from the scope, the alloc and the
    service name, so a registration made again after a client restart
    replaces the first (upstream: the ``_nomad-task-<alloc>-...`` ids)."""
    job = alloc.job
    if job is None:
        return []
    tg = job.lookup_task_group(alloc.task_group)
    if tg is None:
        return []
    services = [(s, "group") for s in (tg.services or [])]
    for task in tg.tasks:
        services.extend((s, task.name) for s in (task.services or []))
    out: List[ServiceRegistration] = []
    for svc, scope in services:
        if svc.provider != "nomad":
            continue   # consul-provider services are not the catalog's
        out.append(ServiceRegistration(
            id=f"_nomad-{scope}-{alloc.id}-{svc.name}",
            service_name=svc.name,
            namespace=job.namespace,
            node_id=alloc.node_id or node.id,
            datacenter=node.datacenter,
            job_id=job.id,
            alloc_id=alloc.id,
            provider="nomad",
            tags=list(svc.tags),
            address=_node_address(node),
            port=_port_by_label(alloc, svc.port_label)))
    return out
