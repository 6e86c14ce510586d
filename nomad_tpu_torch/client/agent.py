"""Simulated client agent: the node-side loop with a mock driver (port
of nomad_tpu/client/agent.py; upstream: client/client.go
registerAndHeartbeat :1734, watchAllocations :2280, runAllocs :2538, and
the scriptable mock driver, drivers/mock/driver.go:117: run_for /
exit_code / start_error). It runs in process beside the server, as the
dev agent does; a node on another host speaks the same calls over the
HTTP API (api/client.py HttpServerConn). The port's server has no
service catalog, so a started alloc registers no services.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from ..structs import (
    AllocDeploymentStatus, Allocation, Node,
    ALLOC_CLIENT_COMPLETE, ALLOC_CLIENT_FAILED, ALLOC_CLIENT_PENDING,
    ALLOC_CLIENT_RUNNING, ALLOC_DESIRED_RUN,
)


def _parse_duration(val) -> float:
    if val is None:
        return 0.0
    if isinstance(val, (int, float)):
        return float(val)
    s = str(val).strip()
    if s.endswith("ms"):
        return float(s[:-2]) / 1000.0
    if s.endswith("s"):
        return float(s[:-1])
    if s.endswith("m"):
        return float(s[:-1]) * 60.0
    try:
        return float(s)
    except ValueError:
        return 0.0


class _TaskState:
    __slots__ = ("started_at", "run_for", "will_fail", "done", "healthy_at",
                 "health_reported")

    def __init__(self, started_at, run_for, will_fail,
                 min_healthy_time: float = 0.05):
        self.started_at = started_at
        self.run_for = run_for
        self.will_fail = will_fail
        self.done = False
        # min_healthy_time gate (upstream: UpdateStrategy.MinHealthyTime +
        # allocrunner health_hook); the sim caps it to keep tests fast
        self.healthy_at = started_at + min(min_healthy_time, 0.3)
        self.health_reported = False


class SimClient(threading.Thread):
    """One simulated node agent."""

    def __init__(self, server, node: Node, poll_interval: float = 0.05):
        super().__init__(daemon=True, name=f"client-{node.name}")
        self.server = server
        self.node = node
        self.poll_interval = poll_interval
        self._stop_ev = threading.Event()
        self._frozen = threading.Event()   # simulate network partition
        self._tasks: Dict[str, _TaskState] = {}
        self._last_hb = 0.0

    # -- failure injection -------------------------------------------------
    def freeze(self) -> None:
        """Stop heartbeating + status updates (simulates partition/crash)."""
        self._frozen.set()

    def thaw(self) -> None:
        self._frozen.clear()

    def stop(self) -> None:
        self._stop_ev.set()

    # ----------------------------------------------------------------------
    def run(self) -> None:
        self.server.register_node(self.node)
        while not self._stop_ev.is_set():
            if not self._frozen.is_set():
                self._heartbeat_if_due()
                self._reconcile_allocs()
            time.sleep(self.poll_interval)

    def _heartbeat_if_due(self) -> None:
        ttl = self.server.heartbeat_ttl
        now = time.time()
        if now - self._last_hb >= max(ttl / 3.0, 0.05):
            self.server.heartbeat(self.node.id)
            self._last_hb = now

    def _reconcile_allocs(self) -> None:
        """The client's pull loop: diff desired state vs running tasks
        (upstream: watchAllocations + runAllocs)."""
        allocs = self.server.state.allocs_by_node(self.node.id)
        updates: List[Allocation] = []
        now = time.time()
        for alloc in allocs:
            if alloc.desired_status == ALLOC_DESIRED_RUN:
                if alloc.client_status == ALLOC_CLIENT_PENDING and \
                        alloc.id not in self._tasks:
                    updates.extend(self._start_alloc(alloc, now))
                elif alloc.id in self._tasks:
                    upd = self._advance_task(alloc, now)
                    if upd is not None:
                        updates.append(upd)
            else:
                # desired stop/evict -> kill the task
                if alloc.id in self._tasks and \
                        not alloc.client_terminal_status():
                    self._tasks.pop(alloc.id, None)
                    updates.append(self._mk_update(
                        alloc, ALLOC_CLIENT_COMPLETE))
        if updates:
            self.server.update_allocs_from_client(updates)

    def _start_alloc(self, alloc: Allocation, now: float) -> List[Allocation]:
        cfg = {}
        min_healthy = 0.05
        if alloc.job is not None:
            tg = alloc.job.lookup_task_group(alloc.task_group)
            if tg is not None:
                if tg.tasks:
                    cfg = tg.tasks[0].config or {}
                update = tg.update or alloc.job.update
                if update is not None:
                    min_healthy = update.min_healthy_time_s
        if cfg.get("start_error"):
            return [self._mk_update(alloc, ALLOC_CLIENT_FAILED,
                                    desc=str(cfg["start_error"]))]
        run_for = _parse_duration(cfg.get("run_for"))
        will_fail = int(cfg.get("exit_code", 0) or 0) != 0
        self._tasks[alloc.id] = _TaskState(now, run_for, will_fail,
                                           min_healthy)
        return [self._mk_update(alloc, ALLOC_CLIENT_RUNNING)]

    def _advance_task(self, alloc: Allocation,
                      now: float) -> Optional[Allocation]:
        ts = self._tasks.get(alloc.id)
        if ts is None or ts.done:
            return None
        if ts.run_for > 0 and now - ts.started_at >= ts.run_for:
            ts.done = True
            self._tasks.pop(alloc.id, None)
            status = (ALLOC_CLIENT_FAILED if ts.will_fail
                      else ALLOC_CLIENT_COMPLETE)
            return self._mk_update(alloc, status)
        if alloc.client_status != ALLOC_CLIENT_RUNNING:
            return self._mk_update(alloc, ALLOC_CLIENT_RUNNING)
        # deployment health only after surviving min_healthy_time, and
        # never for tasks doomed to fail (upstream: health_hook watches
        # the running task for the min window before reporting)
        if (not ts.health_reported and not ts.will_fail
                and now >= ts.healthy_at and alloc.deployment_id):
            ts.health_reported = True
            return self._mk_update(alloc, ALLOC_CLIENT_RUNNING, healthy=True)
        return None

    def _mk_update(self, alloc: Allocation, status: str, healthy: bool = False,
                   desc: str = "") -> Allocation:
        upd = Allocation(id=alloc.id, namespace=alloc.namespace,
                         node_id=alloc.node_id, job_id=alloc.job_id,
                         task_group=alloc.task_group)
        upd.client_status = status
        upd.client_description = desc
        upd.task_states = {"task": {"state": status}}
        if status == ALLOC_CLIENT_FAILED:
            upd.client_terminal_time = time.time()
        if alloc.deployment_id and (healthy or status == ALLOC_CLIENT_FAILED):
            upd.deployment_status = AllocDeploymentStatus(
                healthy=(status != ALLOC_CLIENT_FAILED),
                timestamp=time.time(),
                canary=(alloc.deployment_status.canary
                        if alloc.deployment_status is not None else False))
        return upd
