"""Resource model: task asks, node capacities, comparable arithmetic
(port of nomad_tpu/structs/resources.py; upstream:
nomad/structs/structs.go Resources / NodeResources / AllocatedResources
and funcs.go ComparableResources). Plain dataclasses whose fields map
onto the node-axis columns of tensor/pack.py.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Tuple

# The agent-default dynamic port range (reference: structs.go
# DefaultMinDynamicPort/DefaultMaxDynamicPort). ONE definition: the
# NetworkIndex seed (structs/network.py) and the tensorizer's
# missing-node fallback (tensor/pack.py) both read these, so the
# fallback can never silently diverge from the struct defaults.
DEFAULT_MIN_DYNAMIC_PORT = 20000
DEFAULT_MAX_DYNAMIC_PORT = 32000


@dataclass
class Port:
    """A single named port request (reference: structs.Port)."""

    label: str = ""
    value: int = 0          # static port; 0 => dynamic
    to: int = 0             # mapped-to port inside the task namespace
    host_network: str = "default"


@dataclass
class NetworkResource:
    """Network ask / node NIC description (reference: structs.NetworkResource)."""

    mode: str = "host"      # host | bridge | none | cni/<name>
    device: str = ""
    cidr: str = ""
    ip: str = ""
    mbits: int = 0
    dns: Optional[dict] = None
    reserved_ports: List[Port] = field(default_factory=list)
    dynamic_ports: List[Port] = field(default_factory=list)

    def copy(self) -> "NetworkResource":
        return NetworkResource(
            mode=self.mode, device=self.device, cidr=self.cidr, ip=self.ip,
            mbits=self.mbits, dns=dict(self.dns) if self.dns else None,
            reserved_ports=[replace(p) for p in self.reserved_ports],
            dynamic_ports=[replace(p) for p in self.dynamic_ports],
        )


@dataclass
class DeviceRequest:
    """A task's device ask, e.g. "nvidia/gpu" x2 (reference: structs.RequestedDevice)."""

    name: str = ""          # vendor/type/name, type, or vendor/type
    count: int = 1
    constraints: list = field(default_factory=list)   # [Constraint]
    affinities: list = field(default_factory=list)    # [Affinity]

    def id_tuple(self) -> Tuple[str, ...]:
        return tuple(self.name.split("/"))


@dataclass
class Resources:
    """Per-task resource ask (reference: structs.Resources).

    ``cpu`` is in MHz-shares, ``cores`` asks for exclusive physical cores
    (mutually amplifying with cpu as in the reference's numalib model --
    when cores > 0 the cpu shares are derived from the core count).
    """

    cpu: int = 100
    cores: int = 0
    memory_mb: int = 300
    memory_max_mb: int = 0
    disk_mb: int = 0
    networks: List[NetworkResource] = field(default_factory=list)
    devices: List[DeviceRequest] = field(default_factory=list)


@dataclass
class NodeCpuResources:
    cpu_shares: int = 0          # total MHz across all cores
    total_core_count: int = 0
    reservable_cores: List[int] = field(default_factory=list)


@dataclass
class NodeMemoryResources:
    memory_mb: int = 0


@dataclass
class NodeDiskResources:
    disk_mb: int = 0


def _device_matches_request(dev, req_name: str) -> bool:
    """Shared device-name matching for node groups AND allocated
    holdings: <type>, <vendor>/<type>, or <vendor>/<type>/<name>
    (reference: structs.NodeDeviceResource.ID matching)."""
    parts = req_name.split("/")
    if len(parts) == 1:
        return parts[0] == dev.type
    if len(parts) == 2:
        return parts[0] == dev.vendor and parts[1] == dev.type
    if len(parts) == 3:
        return (parts[0] == dev.vendor and parts[1] == dev.type
                and parts[2] == dev.name)
    return False


@dataclass
class NodeDeviceResource:
    """One device group on a node (reference: structs.NodeDeviceResource)."""

    vendor: str = ""
    type: str = ""
    name: str = ""
    instance_ids: List[str] = field(default_factory=list)
    attributes: Dict[str, object] = field(default_factory=dict)

    def id_string(self) -> str:
        return f"{self.vendor}/{self.type}/{self.name}"

    def matches_request(self, req_name: str) -> bool:
        return _device_matches_request(self, req_name)


@dataclass
class NodeResources:
    """Total capacity of a node (reference: structs.NodeResources)."""

    cpu: NodeCpuResources = field(default_factory=NodeCpuResources)
    memory: NodeMemoryResources = field(default_factory=NodeMemoryResources)
    disk: NodeDiskResources = field(default_factory=NodeDiskResources)
    networks: List[NetworkResource] = field(default_factory=list)
    devices: List[NodeDeviceResource] = field(default_factory=list)
    min_dynamic_port: int = DEFAULT_MIN_DYNAMIC_PORT
    max_dynamic_port: int = DEFAULT_MAX_DYNAMIC_PORT

    def comparable(self) -> "ComparableResources":
        return ComparableResources(
            cpu_shares=self.cpu.cpu_shares,
            memory_mb=self.memory.memory_mb,
            disk_mb=self.disk.disk_mb,
        )


@dataclass
class NodeReservedResources:
    """Resources the node agent holds back from scheduling."""

    cpu_shares: int = 0
    memory_mb: int = 0
    disk_mb: int = 0
    reserved_ports: List[int] = field(default_factory=list)
    cores: List[int] = field(default_factory=list)

    def comparable(self) -> "ComparableResources":
        return ComparableResources(
            cpu_shares=self.cpu_shares, memory_mb=self.memory_mb,
            disk_mb=self.disk_mb, reserved_cores=list(self.cores),
        )


@dataclass
class AllocatedPortMapping:
    label: str = ""
    value: int = 0
    to: int = 0
    host_ip: str = ""


@dataclass
class AllocatedTaskResources:
    """What one task actually got (reference: structs.AllocatedTaskResources)."""

    cpu_shares: int = 0
    reserved_cores: List[int] = field(default_factory=list)
    memory_mb: int = 0
    memory_max_mb: int = 0
    networks: List[NetworkResource] = field(default_factory=list)
    devices: List["AllocatedDeviceResource"] = field(default_factory=list)


@dataclass
class AllocatedDeviceResource:
    vendor: str = ""
    type: str = ""
    name: str = ""
    device_ids: List[str] = field(default_factory=list)

    def id_string(self) -> str:
        return f"{self.vendor}/{self.type}/{self.name}"

    def matches_request(self, req_name: str) -> bool:
        return _device_matches_request(self, req_name)


@dataclass
class AllocatedSharedResources:
    disk_mb: int = 0
    networks: List[NetworkResource] = field(default_factory=list)
    ports: List[AllocatedPortMapping] = field(default_factory=list)


@dataclass
class AllocatedResources:
    """Everything an allocation holds (reference: structs.AllocatedResources)."""

    tasks: Dict[str, AllocatedTaskResources] = field(default_factory=dict)
    shared: AllocatedSharedResources = field(default_factory=AllocatedSharedResources)

    def comparable(self) -> "ComparableResources":
        """Flatten tasks + shared into one additive bundle
        (reference: AllocatedResources.Comparable, structs.go).

        The result is cached on the instance: committed allocs' resources
        are immutable by design (writes replace objects), and the hot
        paths (alloc-table upsert, plan verify, usage packing) call this
        several times per alloc. Contract: do not mutate an
        AllocatedResources after its first comparable() call, and treat
        the returned bundle as read-only."""
        cached = self.__dict__.get("_cmp_cache")
        if cached is not None:
            return cached
        out = ComparableResources(disk_mb=self.shared.disk_mb)
        for tr in self.tasks.values():
            out.cpu_shares += tr.cpu_shares
            out.memory_mb += tr.memory_mb
            out.reserved_cores.extend(tr.reserved_cores)
        out.ports = list(self.shared.ports)
        # plain attribute, not a dataclass field: invisible to the codec
        self.__dict__["_cmp_cache"] = out
        return out

    def has_special_dimensions(self) -> bool:
        """Any ports/networks/reserved-cores/devices on the allocation:
        the dimensions a plain cpu/mem/disk fit cannot model."""
        if self.shared.ports or self.shared.networks:
            return True
        for tr in self.tasks.values():
            if tr.reserved_cores or tr.devices or tr.networks:
                return True
        return False

    def all_ports(self) -> List[int]:
        """Every host port this allocation holds, deduplicated, in
        first-seen order -- the single enumeration used by the port
        bitmap paths (alloc table, usage packing, plan overlays)."""
        seen = []
        seen_set = set()
        for pm in self.shared.ports:
            if pm.value not in seen_set:
                seen_set.add(pm.value)
                seen.append(pm.value)
        for net in self.shared.networks:
            for p in list(net.reserved_ports) + list(net.dynamic_ports):
                if p.value not in seen_set:
                    seen_set.add(p.value)
                    seen.append(p.value)
        return seen


@dataclass
class ComparableResources:
    """Additive, superset-comparable resource bundle
    (reference: structs.ComparableResources in funcs.go)."""

    cpu_shares: int = 0
    memory_mb: int = 0
    disk_mb: int = 0
    reserved_cores: List[int] = field(default_factory=list)
    ports: List[AllocatedPortMapping] = field(default_factory=list)

    def add(self, other: "ComparableResources") -> None:
        self.cpu_shares += other.cpu_shares
        self.memory_mb += other.memory_mb
        self.disk_mb += other.disk_mb
        self.reserved_cores.extend(other.reserved_cores)

    def subtract(self, other: "ComparableResources") -> None:
        self.cpu_shares -= other.cpu_shares
        self.memory_mb -= other.memory_mb
        self.disk_mb -= other.disk_mb
        for c in other.reserved_cores:
            if c in self.reserved_cores:
                self.reserved_cores.remove(c)

    def superset(self, other: "ComparableResources") -> Tuple[bool, str]:
        """Is self >= other on every dimension? Returns (ok, failing-dimension)
        (reference: ComparableResources.Superset)."""
        if self.cpu_shares < other.cpu_shares:
            return False, "cpu"
        if self.memory_mb < other.memory_mb:
            return False, "memory"
        if self.disk_mb < other.disk_mb:
            return False, "disk"
        if other.reserved_cores and not set(other.reserved_cores) <= set(
                self.reserved_cores if self.reserved_cores else []):
            return False, "cores"
        return True, ""

    def copy(self) -> "ComparableResources":
        return ComparableResources(
            cpu_shares=self.cpu_shares, memory_mb=self.memory_mb,
            disk_mb=self.disk_mb, reserved_cores=list(self.reserved_cores),
            ports=list(self.ports),
        )
