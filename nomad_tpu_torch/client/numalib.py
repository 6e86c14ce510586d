"""NUMA topology discovery (port of nomad_tpu/client/numalib.py;
upstream: client/lib/numalib, whose Topology feeds the scheduler's core
selection, scheduler/rank.go:481-524).

Scans /sys/devices/system/node/node*/cpulist into a Topology of NUMA
node -> core ids. Without the sysfs tree (containers, macOS) it
degrades to one synthetic node holding every cpu, as upstream's generic
scanner does.
"""
from __future__ import annotations

import glob
import os
from dataclasses import dataclass, field
from typing import Dict, List


def parse_cpulist(text: str) -> List[int]:
    """Kernel cpulist format: "0-3,8,10-11" -> [0,1,2,3,8,10,11]."""
    out: List[int] = []
    for part in text.strip().split(","):
        part = part.strip()
        if not part:
            continue
        if "-" in part:
            lo, _, hi = part.partition("-")
            out.extend(range(int(lo), int(hi) + 1))
        else:
            out.append(int(part))
    return out


@dataclass
class Topology:
    """(upstream: numalib.Topology)"""

    nodes: Dict[int, List[int]] = field(default_factory=dict)

    @property
    def node_count(self) -> int:
        return len(self.nodes)

    @property
    def core_count(self) -> int:
        return sum(len(v) for v in self.nodes.values())

    def all_cores(self) -> List[int]:
        out: List[int] = []
        for nid in sorted(self.nodes):
            out.extend(self.nodes[nid])
        return sorted(out)

    def node_of(self, core: int) -> int:
        for nid, cores in self.nodes.items():
            if core in cores:
                return nid
        return -1


def scan(sysfs_root: str = "/sys/devices/system/node") -> Topology:
    """Scan the sysfs NUMA tree; synthesizes node0 = all cpus when the
    tree is absent."""
    topo = Topology()
    for path in sorted(glob.glob(os.path.join(sysfs_root, "node[0-9]*"))):
        base = os.path.basename(path)
        try:
            nid = int(base[len("node"):])
        except ValueError:
            continue
        cpulist = os.path.join(path, "cpulist")
        try:
            with open(cpulist, encoding="utf-8") as fh:
                cores = parse_cpulist(fh.read())
        except OSError:
            continue
        if cores:
            topo.nodes[nid] = cores
    if not topo.nodes:
        n = os.cpu_count() or 1
        topo.nodes[0] = list(range(n))
    return topo
