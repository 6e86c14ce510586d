"""Node fingerprinting: fill Node.attributes and NodeResources (port of
nomad_tpu/client/fingerprint.py; upstream: client/fingerprint_manager.go
and client/fingerprint/, one fingerprinter per concern: arch, os, host,
cpu, memory, storage, network, the nomad version). The accelerator
fingerprinter reads the CUDA cards through ``torch.cuda`` and reports
them in the shape of upstream's nvidia device plugin
(plugins/device/): a job can ask ``device "nvidia/gpu"`` and constrain
on ``${attr.gpu.count}``.
"""
from __future__ import annotations

import os
import platform
import shutil
import socket
import time
from typing import Dict, List, Optional, Tuple

from ..structs import (
    Node, NodeCpuResources, NodeDeviceResource, NodeDiskResources,
    NodeMemoryResources, NodeResources, NetworkResource, generate_uuid,
)

VERSION = "0.1.0"


class Fingerprinter:
    """One concern's probe. Returns (attributes, mutate_fn|None)."""

    name = "base"

    def fingerprint(self, node: Node) -> Dict[str, str]:
        raise NotImplementedError


class ArchFingerprinter(Fingerprinter):
    name = "arch"

    def fingerprint(self, node: Node) -> Dict[str, str]:
        return {"cpu.arch": platform.machine()}


class OSFingerprinter(Fingerprinter):
    name = "os"

    def fingerprint(self, node: Node) -> Dict[str, str]:
        return {"os.name": platform.system().lower(),
                "os.version": platform.release(),
                "kernel.name": platform.system().lower(),
                "kernel.version": platform.release()}


class HostFingerprinter(Fingerprinter):
    name = "host"

    def fingerprint(self, node: Node) -> Dict[str, str]:
        return {"unique.hostname": socket.gethostname()}


class CpuFingerprinter(Fingerprinter):
    name = "cpu"

    def fingerprint(self, node: Node) -> Dict[str, str]:
        from . import numalib
        topo = numalib.scan()
        cores = topo.core_count or os.cpu_count() or 1
        mhz = self._base_mhz()
        total = int(cores * mhz)
        node.node_resources.cpu = NodeCpuResources(
            cpu_shares=total, total_core_count=cores,
            reservable_cores=topo.all_cores() or list(range(cores)))
        return {"cpu.numcores": str(cores),
                "cpu.frequency": str(int(mhz)),
                "cpu.totalcompute": str(total),
                "numa.node_count": str(topo.node_count)}

    @staticmethod
    def _base_mhz() -> float:
        try:
            with open("/proc/cpuinfo", encoding="utf-8") as fh:
                for line in fh:
                    if line.lower().startswith("cpu mhz"):
                        return float(line.split(":", 1)[1])
        except (OSError, ValueError):
            pass
        return 1000.0


class MemoryFingerprinter(Fingerprinter):
    name = "memory"

    def fingerprint(self, node: Node) -> Dict[str, str]:
        total_mb = self._total_mb()
        node.node_resources.memory = NodeMemoryResources(
            memory_mb=total_mb)
        return {"memory.totalbytes": str(total_mb << 20)}

    @staticmethod
    def _total_mb() -> int:
        try:
            with open("/proc/meminfo", encoding="utf-8") as fh:
                for line in fh:
                    if line.startswith("MemTotal:"):
                        return int(line.split()[1]) >> 10
        except (OSError, ValueError, IndexError):
            pass
        return 1024


class StorageFingerprinter(Fingerprinter):
    name = "storage"

    def __init__(self, data_dir: str = "/tmp"):
        self.data_dir = data_dir

    def fingerprint(self, node: Node) -> Dict[str, str]:
        try:
            usage = shutil.disk_usage(self.data_dir)
            free_mb = usage.free >> 20
            total_mb = usage.total >> 20
        except OSError:
            free_mb = total_mb = 10240
        node.node_resources.disk = NodeDiskResources(disk_mb=free_mb)
        return {"unique.storage.volume": self.data_dir,
                "unique.storage.bytestotal": str(total_mb << 20),
                "unique.storage.bytesfree": str(free_mb << 20)}


class NetworkFingerprinter(Fingerprinter):
    name = "network"

    def fingerprint(self, node: Node) -> Dict[str, str]:
        ip = "127.0.0.1"
        try:
            # UDP connect learns the outbound interface address; no traffic
            s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            s.connect(("10.255.255.255", 1))
            ip = s.getsockname()[0]
            s.close()
        except OSError:
            pass
        if not node.node_resources.networks:
            node.node_resources.networks = [
                NetworkResource(mode="host", device="eth0", ip=ip,
                                mbits=1000)]
        return {"unique.network.ip-address": ip}


class NomadFingerprinter(Fingerprinter):
    name = "nomad"

    def fingerprint(self, node: Node) -> Dict[str, str]:
        return {"nomad.version": VERSION,
                "nomad.revision": "tpu-native"}


class AcceleratorFingerprinter(Fingerprinter):
    """The node's CUDA cards (reference :158, which probes the TPU
    runtime's device list): ``gpu.count``, ``accelerator.<name>.count`` for
    each card model, and one ``NodeDeviceResource(vendor="nvidia",
    type="gpu", name=<card name>)`` a model, its instance ids the cards'
    UUIDs (their indexes where torch gives none) and its ``memory_mib``
    attribute the card's total memory. Probing is off unless asked, and
    it touches CUDA only when asked: a client on a host without cards
    reports ``gpu.count`` "0" and no device group."""

    name = "accelerator"

    def __init__(self, probe_cuda: bool = False):
        self.probe_cuda = probe_cuda

    def fingerprint(self, node: Node) -> Dict[str, str]:
        if not self.probe_cuda:
            return {}
        import torch

        if not torch.cuda.is_available():
            return {"gpu.count": "0"}
        n = int(torch.cuda.device_count())
        kinds: Dict[str, List[Tuple[str, int]]] = {}
        for i in range(n):
            props = torch.cuda.get_device_properties(i)
            uuid = getattr(props, "uuid", None)
            kinds.setdefault(props.name, []).append(
                (str(uuid) if uuid is not None else str(i),
                 int(props.total_memory)))
        attrs = {"gpu.count": str(n)}
        for kind, cards in kinds.items():
            node.node_resources.devices.append(NodeDeviceResource(
                vendor="nvidia", type="gpu", name=kind,
                instance_ids=[inst for inst, _ in cards],
                attributes={"memory_mib": cards[0][1] >> 20}))
            attrs[f"accelerator.{kind}.count"] = str(len(cards))
        return attrs


DEFAULT_FINGERPRINTERS = (
    ArchFingerprinter, OSFingerprinter, HostFingerprinter, CpuFingerprinter,
    MemoryFingerprinter, StorageFingerprinter, NetworkFingerprinter,
    NomadFingerprinter,
)


class FingerprintManager:
    """Runs every fingerprinter against a Node
    (upstream: client/fingerprint_manager.go setupFingerprinters)."""

    def __init__(self, data_dir: str = "/tmp", probe_cuda: bool = False,
                 extra: Optional[List[Fingerprinter]] = None):
        self.fingerprinters: List[Fingerprinter] = [
            cls(data_dir) if cls is StorageFingerprinter else cls()
            for cls in DEFAULT_FINGERPRINTERS]
        self.fingerprinters.append(AcceleratorFingerprinter(probe_cuda))
        self.fingerprinters.extend(extra or [])

    def fingerprint_node(self, node: Optional[Node] = None,
                         name: str = "", datacenter: str = "dc1",
                         node_class: str = "") -> Node:
        if node is None:
            node = Node(id=generate_uuid(), name=name or socket.gethostname(),
                        datacenter=datacenter, node_class=node_class,
                        node_resources=NodeResources())
        applied = []
        for fp in self.fingerprinters:
            try:
                attrs = fp.fingerprint(node)
            except Exception:   # noqa: BLE001 - a probe must not kill boot
                continue
            node.attributes.update(attrs)
            applied.append(fp.name)
        node.attributes["fingerprinters"] = ",".join(applied)
        node.compute_class()
        return node
