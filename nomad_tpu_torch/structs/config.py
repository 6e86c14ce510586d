"""Runtime scheduler configuration (port of nomad_tpu/structs/config.py;
upstream: nomad/structs/operator.go SchedulerConfiguration, read per eval
at scheduler/stack.go:292 and rank.go:192).

``tpu-binpack`` / ``tpu-spread`` are binpack / spread semantics with the
inner loop run by the solver (on the port: the H100's kernels);
``tpu-lpq`` solves a coalesced queue as one LP relaxation.
"""
from __future__ import annotations

from dataclasses import dataclass, field

SCHED_ALG_BINPACK = "binpack"
SCHED_ALG_SPREAD = "spread"
SCHED_ALG_TPU_BINPACK = "tpu-binpack"
SCHED_ALG_TPU_SPREAD = "tpu-spread"
SCHED_ALG_TPU_LPQ = "tpu-lpq"


@dataclass
class PreemptionConfig:
    system_scheduler_enabled: bool = True
    sysbatch_scheduler_enabled: bool = False
    batch_scheduler_enabled: bool = False
    service_scheduler_enabled: bool = False

    def is_enabled(self, scheduler_type: str) -> bool:
        return {
            "system": self.system_scheduler_enabled,
            "sysbatch": self.sysbatch_scheduler_enabled,
            "batch": self.batch_scheduler_enabled,
            "service": self.service_scheduler_enabled,
        }.get(scheduler_type, False)


@dataclass
class SchedulerConfiguration:
    scheduler_algorithm: str = SCHED_ALG_BINPACK
    preemption_config: PreemptionConfig = field(
        default_factory=PreemptionConfig)
    memory_oversubscription_enabled: bool = False
    reject_job_registration: bool = False
    pause_eval_broker: bool = False
    create_index: int = 0
    modify_index: int = 0

    def effective_algorithm(self, node_pool=None) -> str:
        """Node pools may override the global algorithm
        (upstream: structs/node_pool.go)."""
        if node_pool is not None and getattr(node_pool,
                                             "scheduler_algorithm", ""):
            return node_pool.scheduler_algorithm
        return self.scheduler_algorithm

    def uses_tpu(self) -> bool:
        return self.scheduler_algorithm in (SCHED_ALG_TPU_BINPACK,
                                            SCHED_ALG_TPU_SPREAD,
                                            SCHED_ALG_TPU_LPQ)
