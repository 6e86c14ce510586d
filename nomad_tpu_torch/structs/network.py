"""Port accounting: the NetworkIndex (port of
nomad_tpu/structs/network.py; upstream: nomad/structs/network.go
NetworkIndex, SetNode, AddAllocs, AssignPorts). A flat 65536-bit port
bitmap per node, held as a Python int used as a bitset; tensor/pack.py
packs the same bitmap as 2048 x uint32 words.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from .resources import (
    AllocatedPortMapping, NetworkResource,
    DEFAULT_MAX_DYNAMIC_PORT, DEFAULT_MIN_DYNAMIC_PORT,
)

MAX_VALID_PORT = 65536


class PortBitmap:
    """A 65536-slot used-port set backed by an int bitset."""

    __slots__ = ("bits",)

    def __init__(self) -> None:
        self.bits = 0

    def check(self, port: int) -> bool:
        return bool((self.bits >> port) & 1)

    def set(self, port: int) -> None:
        self.bits |= (1 << port)

    def clear(self, port: int) -> None:
        self.bits &= ~(1 << port)

    def used_count(self) -> int:
        return bin(self.bits).count("1")

    def copy(self) -> "PortBitmap":
        out = PortBitmap()
        out.bits = self.bits
        return out


@dataclass
class AssignedPorts:
    ports: List[AllocatedPortMapping] = field(default_factory=list)


class NetworkIndex:
    """Tracks port usage on one node (reference: structs.NetworkIndex).

    Holds one bitmap per host-network (we model the common single-network
    case plus named host networks), supports speculative AddAllocs /
    AssignPorts exactly where the reference's bin-packer calls them
    (reference: scheduler/rank.go:330-470).
    """

    def __init__(self) -> None:
        self.used: dict = {}        # host_network name -> PortBitmap
        self.node_networks: List[NetworkResource] = []
        self.min_dynamic_port = DEFAULT_MIN_DYNAMIC_PORT
        self.max_dynamic_port = DEFAULT_MAX_DYNAMIC_PORT

    def _bitmap(self, host_network: str = "default") -> PortBitmap:
        bm = self.used.get(host_network)
        if bm is None:
            bm = PortBitmap()
            self.used[host_network] = bm
        return bm

    def set_node(self, node) -> Optional[str]:
        """Load node NICs + agent-reserved ports. Returns error string on
        reserved-port collision (reference: NetworkIndex.SetNode)."""
        self.node_networks = list(node.node_resources.networks)
        self.min_dynamic_port = node.node_resources.min_dynamic_port
        self.max_dynamic_port = node.node_resources.max_dynamic_port
        bm = self._bitmap()
        for p in node.reserved_resources.reserved_ports:
            if not 0 <= p < MAX_VALID_PORT:
                return f"invalid reserved port {p}"
            bm.set(p)
        return None

    def add_allocs(self, allocs) -> Tuple[bool, str]:
        """Mark ports of existing allocs used; detect collisions
        (reference: NetworkIndex.AddAllocs)."""
        collide, reason = False, ""
        for alloc in allocs:
            # Only client-terminal allocs have actually released their ports
            # (reference: NetworkIndex.AddAllocs skips ClientTerminalStatus
            # only -- a desired=stop alloc still binds until the client acts).
            if alloc.client_terminal_status():
                continue
            for pm in alloc.allocated_resources.shared.ports:
                ok, why = self.add_reserved_port(
                    pm.value, self._network_for_ip(pm.host_ip))
                if not ok:
                    collide, reason = True, why
            for net in alloc.allocated_resources.shared.networks:
                for p in net.reserved_ports + net.dynamic_ports:
                    ok, why = self.add_reserved_port(p.value, p.host_network)
                    if not ok:
                        collide, reason = True, why
        return collide, reason

    def add_reserved_port(self, port: int,
                          host_network: str = "default") -> Tuple[bool, str]:
        if not 0 <= port < MAX_VALID_PORT:
            return False, f"invalid port {port}"
        bm = self._bitmap(host_network or "default")
        if bm.check(port):
            return False, f"port {port} already in use"
        bm.set(port)
        return True, ""

    def overcommitted(self) -> bool:
        # Bandwidth accounting is deprecated in the reference
        # (network.go Overcommitted returns false); keep the hook.
        return False

    def assign_ports(self, ask: List[NetworkResource], rng=None
                     ) -> Tuple[Optional[AssignedPorts], str]:
        """Assign reserved + dynamic ports for a task-group network ask
        (reference: NetworkIndex.AssignPorts). Deterministic: dynamic ports
        are taken as the lowest free ports in [min_dynamic, max_dynamic] --
        a deliberate re-design of the reference's random probing so the host
        oracle and the TPU solver agree bit-for-bit."""
        out = AssignedPorts()
        default_ip = self.node_networks[0].ip if self.node_networks else "127.0.0.1"
        # One speculative bitmap per host network touched by this ask.
        speculative: dict = {}

        def spec(name: str) -> PortBitmap:
            name = name or "default"
            if name not in speculative:
                speculative[name] = self._bitmap(name).copy()
            return speculative[name]

        for net in ask:
            for p in net.reserved_ports:
                bm = spec(p.host_network)
                if bm.check(p.value):
                    return None, f"reserved port collision {p.label}={p.value}"
                bm.set(p.value)
                out.ports.append(AllocatedPortMapping(
                    label=p.label, value=p.value, to=p.to or p.value,
                    host_ip=self._ip_for_network(p.host_network) or default_ip))
            for p in net.dynamic_ports:
                bm = spec(p.host_network)
                port = self._pick_dynamic(bm)
                if port < 0:
                    return None, "dynamic port selection failed"
                bm.set(port)
                out.ports.append(AllocatedPortMapping(
                    label=p.label, value=port, to=p.to or port,
                    host_ip=self._ip_for_network(p.host_network) or default_ip))
        return out, ""

    def _network_for_ip(self, ip: str) -> str:
        """Map an allocated host_ip back to its host-network name. The
        node's first NIC is the "default" host network; named networks are
        keyed by device so their port spaces stay independent."""
        for i, net in enumerate(self.node_networks):
            if net.ip == ip:
                return "default" if i == 0 else (net.device or "default")
        return "default"

    def _ip_for_network(self, host_network: str) -> str:
        if not host_network or host_network == "default":
            return ""
        for net in self.node_networks:
            if net.device == host_network:
                return net.ip
        return ""

    def _pick_dynamic(self, bm: PortBitmap) -> int:
        lo, hi = self.min_dynamic_port, self.max_dynamic_port
        # Mask bits [lo, hi] and find lowest zero via bit tricks.
        window = (bm.bits >> lo) & ((1 << (hi - lo + 1)) - 1)
        inv = ~window & ((1 << (hi - lo + 1)) - 1)
        if inv == 0:
            return -1
        return lo + (inv & -inv).bit_length() - 1
