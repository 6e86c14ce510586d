"""Scheduler factory registry (port of nomad_tpu/scheduler/factory.py;
upstream: scheduler/scheduler.go:27-49 Factory and BuiltinSchedulers).

Scheduler names are the eval types (service, batch, system, sysbatch)
plus the LP tier's ``tpu-lpq``; the placement algorithm (binpack, spread,
tpu-binpack, tpu-spread, tpu-lpq) is the scheduler configuration's."""
from __future__ import annotations

from typing import Callable, Dict

_REGISTRY: Dict[str, Callable] = {}


def register_scheduler(name: str, factory: Callable) -> None:
    _REGISTRY[name] = factory


def new_scheduler(name: str, state, planner, **kwargs):
    """The registered scheduler ``name`` over ``state`` and ``planner``;
    ``kwargs`` (solve_hook, device) go to its constructor."""
    factory = _REGISTRY.get(name)
    if factory is None:
        raise ValueError(f"unknown scheduler '{name}'")
    return factory(state, planner, **kwargs)


def _register_builtins() -> None:
    from .generic import GenericScheduler
    from .system import SystemScheduler
    register_scheduler(
        "service", lambda state, planner, **kw:
        GenericScheduler(state, planner, batch=False, **kw))
    register_scheduler(
        "batch", lambda state, planner, **kw:
        GenericScheduler(state, planner, batch=True, **kw))
    # the LP tier: a GenericScheduler whose solve hook meets the queue at
    # an LpqBarrier (lpq.make_lpq_hook) instead of the SolveBarrier
    register_scheduler(
        "tpu-lpq", lambda state, planner, batch=False, **kw:
        GenericScheduler(state, planner, batch=batch, **kw))
    register_scheduler(
        "system", lambda state, planner, **kw:
        SystemScheduler(state, planner, sysbatch=False, **kw))
    register_scheduler(
        "sysbatch", lambda state, planner, **kw:
        SystemScheduler(state, planner, sysbatch=True, **kw))


_register_builtins()
