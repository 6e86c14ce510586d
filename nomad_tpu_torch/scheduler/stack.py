"""The task-group constraint merge of the placement stack (port of
nomad_tpu/scheduler/stack.py _tg_constraints; upstream: stack.go
taskGroupConstraints). The stacks themselves come with the scheduler
slice."""
from __future__ import annotations


def _tg_constraints(tg):
    """The drivers and the merged constraints of a task group."""
    drivers = set()
    constraints = list(tg.constraints)
    for task in tg.tasks:
        drivers.add(task.driver)
        constraints.extend(task.constraints)
    return drivers, constraints
