"""The compiled host-baseline oracle (port of
nomad_tpu/scheduler/native_oracle.py).

Packs a (nodes, job, task group) world into the dense arrays the native
``nt_solve_eval`` consumes (csrc/pack_kernels.cc) and runs the host
scheduler's per-eval inner loop -- seeded shuffle, log2-window binpack
select, usage carried (upstream scheduler/rank.go:205, stack.go:82-95,
select.go, util.go:167) -- as compiled C++. It is the baseline the
device solver's ``vs_native_host`` is to be measured against; it equals
the host stack's placements (tests/test_torch_native_oracle.py).

Scope: cpu / memory / disk asks, eligibility from the job's and task
group's constraints and driver presence, binpack or spread scoring, job
anti-affinity. Asks with ports, devices or cores are outside it
(``supported``).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np

from .. import native
from ..structs import Job, Node, TaskGroup
from .context import EvalContext
from .feasible import ConstraintChecker, DriverChecker
from .util import shuffle_seed


class PackedWorld:
    """(reference :30) Dense node-axis arrays for the oracle, in base
    node order."""

    def __init__(self, nodes: List[Node], ctx: EvalContext, job: Job,
                 tg: TaskGroup):
        n = len(nodes)
        self.nodes = nodes
        self.cpu_cap = np.empty(n, dtype=np.float64)
        self.mem_cap = np.empty(n, dtype=np.float64)
        self.disk_cap = np.empty(n, dtype=np.float64)
        self.used_cpu = np.zeros(n, dtype=np.float64)
        self.used_mem = np.zeros(n, dtype=np.float64)
        self.used_disk = np.zeros(n, dtype=np.float64)
        self.placed_jobtg = np.zeros(n, dtype=np.int32)
        self.eligible = np.ones(n, dtype=np.uint8)

        for k, node in enumerate(nodes):
            nr, rr = node.node_resources, node.reserved_resources
            self.cpu_cap[k] = nr.cpu.cpu_shares - rr.cpu_shares
            self.mem_cap[k] = nr.memory.memory_mb - rr.memory_mb
            self.disk_cap[k] = nr.disk.disk_mb - rr.disk_mb
            for alloc in ctx.proposed_allocs(node.id):
                cr = alloc.allocated_resources.comparable()
                self.used_cpu[k] += cr.cpu_shares
                self.used_mem[k] += cr.memory_mb
                self.used_disk[k] += cr.disk_mb
                if alloc.job_id == job.id and alloc.task_group == tg.name:
                    self.placed_jobtg[k] += 1

        # eligibility: the job's and group's constraints and the drivers,
        # the boolean the feasibility wrapper memoizes per computed class
        drivers = set()
        constraints = list(job.constraints) + list(tg.constraints)
        for task in tg.tasks:
            drivers.add(task.driver)
            constraints.extend(task.constraints)
        ccheck = ConstraintChecker(ctx, constraints)
        dcheck = DriverChecker(ctx, drivers)
        for k, node in enumerate(nodes):
            if not (dcheck.feasible(node) and ccheck.feasible(node)):
                self.eligible[k] = 0

        # the task group's ask, one combined alloc footprint
        self.ask_cpu = float(sum(t.resources.cpu for t in tg.tasks))
        self.ask_mem = float(sum(t.resources.memory_mb for t in tg.tasks))
        self.ask_disk = float(tg.ephemeral_disk.size_mb
                              if tg.ephemeral_disk else 0)


def supported(tg: TaskGroup) -> bool:
    """True when the oracle covers this ask's shape."""
    if tg.networks:
        return False
    return not any(t.resources.devices or t.resources.cores
                   for t in tg.tasks)


def scan_limit(n_nodes: int, batch: bool) -> int:
    """max(2, ceil(log2 n)) for service jobs (upstream stack.go:82-95)."""
    limit = 2
    if not batch and n_nodes > 1:
        limit = max(limit, int(math.ceil(math.log2(n_nodes))))
    return limit


def solve(world: PackedWorld, eval_id: str, state_index: int,
          n_placements: int, desired_count: int, batch: bool = False,
          spread_alg: bool = False) -> Dict[int, Optional[str]]:
    """Run the oracle: {placement index: node id, or None when nothing
    fits}. Mutates the world's usage arrays (the carry a plan gives the
    host stack)."""
    choices = native.solve_eval_native(
        world.cpu_cap, world.mem_cap, world.disk_cap,
        world.used_cpu, world.used_mem, world.used_disk,
        world.placed_jobtg, world.eligible,
        shuffle_seed(eval_id, state_index),
        world.ask_cpu, world.ask_mem, world.ask_disk,
        desired_count, scan_limit(len(world.nodes), batch), n_placements,
        spread_alg=spread_alg)
    return {i: (world.nodes[int(c)].id if c >= 0 else None)
            for i, c in enumerate(choices)}
