"""The placement ask of the reconciler (port of
nomad_tpu/scheduler/reconcile.py AllocPlaceResult; upstream:
reconcile.go allocPlaceResult). The reconciler comes with the scheduler
slice."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..structs import Allocation, TaskGroup


@dataclass
class AllocPlaceResult:
    """One placement ask."""

    name: str = ""
    canary: bool = False
    task_group: Optional[TaskGroup] = None
    previous_alloc: Optional[Allocation] = None
    reschedule: bool = False
    previous_lost: bool = False
    downgrade_non_canary: bool = False
    min_job_version: int = 0
