"""Job / TaskGroup / Task model plus constraints, affinities, spreads
(port of nomad_tpu/structs/job.py; upstream: nomad/structs/structs.go).
Every field the scheduler reads is present, and the periodic launch
spec the server's launcher reads (PeriodicConfig), the dispatch contract
of a parameterized job (ParameterizedJobConfig), and the scaling policy
and scaling event records the store derives and keeps (ScalingPolicy,
ScalingEvent), and the native service catalog's entries
(ServiceRegistration); multiregion configuration is not ported (its Job field
stays, holding None).
"""
from __future__ import annotations

import random
import uuid
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .resources import NetworkResource, Resources

# Job types (reference: structs.go JobType*)
JOB_TYPE_SERVICE = "service"
JOB_TYPE_BATCH = "batch"
JOB_TYPE_SYSTEM = "system"
JOB_TYPE_SYSBATCH = "sysbatch"
JOB_TYPE_CORE = "_core"

# Job statuses
JOB_STATUS_PENDING = "pending"
JOB_STATUS_RUNNING = "running"
JOB_STATUS_DEAD = "dead"

# Constraint operands (reference: structs.go Constraint*)
CONSTRAINT_DISTINCT_HOSTS = "distinct_hosts"
CONSTRAINT_DISTINCT_PROPERTY = "distinct_property"
CONSTRAINT_REGEX = "regexp"
CONSTRAINT_VERSION = "version"
CONSTRAINT_SEMVER = "semver"
CONSTRAINT_SET_CONTAINS = "set_contains"
CONSTRAINT_SET_CONTAINS_ALL = "set_contains_all"
CONSTRAINT_SET_CONTAINS_ANY = "set_contains_any"
CONSTRAINT_ATTR_IS_SET = "is_set"
CONSTRAINT_ATTR_IS_NOT_SET = "is_not_set"

DEFAULT_NAMESPACE = "default"
DEFAULT_NODE_POOL = "default"

JOB_DEFAULT_PRIORITY = 50
JOB_MAX_PRIORITY = 100


# uuid4-format ids from a per-thread PRNG stream (no syscall per id).
# ``reseed_ids`` pins the streams: eval ids seed the node shuffle, so a
# seeded stream makes placements reproducible. Each thread derives its
# stream from (base seed, thread name, incarnation); the thread that
# calls reseed_ids keeps the base stream itself.
import hashlib as _hashlib
import threading as _threading

_id_base: List[Optional[int]] = [None]
_id_epoch = [0]
_id_tls = _threading.local()
_id_incarnations: dict = {}
_id_inc_lock = _threading.Lock()


def reseed_ids(seed: int) -> None:
    """Re-pin the id stream (test hook: deterministic tie-breaks).
    The calling thread takes the base stream; every other thread
    derives its own from (seed, thread name, incarnation) on first
    draw."""
    _id_base[0] = seed
    _id_epoch[0] += 1
    with _id_inc_lock:
        _id_incarnations.clear()
    _id_tls.rng = random.Random(seed)
    _id_tls.epoch = _id_epoch[0]


def _thread_rng() -> random.Random:
    rng = getattr(_id_tls, "rng", None)
    if rng is not None and getattr(_id_tls, "epoch", -1) == _id_epoch[0]:
        return rng
    base = _id_base[0]
    if base is None:
        seed = uuid.uuid4().int          # unseeded: fresh entropy
    else:
        name = _threading.current_thread().name
        with _id_inc_lock:
            inc = _id_incarnations.get(name, 0)
            _id_incarnations[name] = inc + 1
        # inc=0 keeps the legacy "{base}:{name}" seed so first
        # incarnations reproduce the exact pre-fix stream
        tag = f"{base}:{name}" if inc == 0 else f"{base}:{name}:{inc}"
        seed = int.from_bytes(
            _hashlib.blake2b(tag.encode(),
                             digest_size=8).digest(), "little")
    rng = random.Random(seed)
    _id_tls.rng = rng
    _id_tls.epoch = _id_epoch[0]
    return rng


_UUID_VARIANT = "89ab"


def generate_uuid() -> str:
    h = f"{_thread_rng().getrandbits(128):032x}"
    # force the RFC-4122 version (4) and variant (10xx) nibbles so the
    # output validates as a real uuid4 everywhere
    return (f"{h[:8]}-{h[8:12]}-4{h[13:16]}-"
            f"{_UUID_VARIANT[int(h[16], 16) & 3]}{h[17:20]}-{h[20:]}")


@dataclass
class Constraint:
    """A hard placement filter (reference: structs.Constraint)."""

    l_target: str = ""      # e.g. "${attr.kernel.name}"
    r_target: str = ""      # e.g. "linux"
    operand: str = "="      # =, !=, <, <=, >, >=, regexp, version, semver,
                            # set_contains*, is_set, is_not_set,
                            # distinct_hosts, distinct_property

    def __str__(self) -> str:
        return f"{self.l_target} {self.operand} {self.r_target}"


@dataclass
class Affinity:
    """A soft placement preference with weight in [-100, 100]
    (reference: structs.Affinity)."""

    l_target: str = ""
    r_target: str = ""
    operand: str = "="
    weight: int = 50


@dataclass
class SpreadTarget:
    value: str = ""
    percent: int = 0


@dataclass
class Spread:
    """Spread allocations over values of an attribute
    (reference: structs.Spread)."""

    attribute: str = ""     # e.g. "${node.datacenter}"
    weight: int = 50        # (0, 100]
    spread_target: List[SpreadTarget] = field(default_factory=list)


@dataclass
class RestartPolicy:
    """Client-side task restart policy (reference: structs.RestartPolicy)."""

    attempts: int = 2
    interval_s: float = 1800.0
    delay_s: float = 15.0
    mode: str = "fail"      # fail | delay
    render_templates: bool = False


@dataclass
class ReschedulePolicy:
    """Server-side replacement policy for failed allocs
    (reference: structs.ReschedulePolicy)."""

    attempts: int = 0
    interval_s: float = 0.0
    delay_s: float = 30.0
    delay_function: str = "exponential"   # constant | exponential | fibonacci
    max_delay_s: float = 3600.0
    unlimited: bool = True


@dataclass
class MigrateStrategy:
    max_parallel: int = 1
    health_check: str = "checks"
    min_healthy_time_s: float = 10.0
    healthy_deadline_s: float = 300.0


@dataclass
class UpdateStrategy:
    """Rolling update / canary configuration (reference: structs.UpdateStrategy)."""

    stagger_s: float = 30.0
    max_parallel: int = 1
    health_check: str = "checks"
    min_healthy_time_s: float = 10.0
    healthy_deadline_s: float = 300.0
    progress_deadline_s: float = 600.0
    auto_revert: bool = False
    auto_promote: bool = False
    canary: int = 0

    def is_empty(self) -> bool:
        return self.max_parallel == 0


@dataclass
class EphemeralDisk:
    sticky: bool = False
    size_mb: int = 300
    migrate: bool = False


@dataclass
class VolumeRequest:
    name: str = ""
    type: str = "host"      # host | csi
    source: str = ""
    read_only: bool = False
    access_mode: str = ""
    attachment_mode: str = ""
    per_alloc: bool = False

    def source_for(self, alloc_name: str) -> str:
        """Effective volume source: per_alloc volumes append the alloc's
        bracket index, e.g. source[3] (reference: structs.VolumeRequest
        + alloc name indexing). The ONE place this rule lives -- the
        scheduler's checkers and the state store's claim writer must
        agree on it."""
        if self.per_alloc and alloc_name and "[" in alloc_name:
            return f"{self.source}{alloc_name[alloc_name.rfind('['):]}"
        return self.source


@dataclass
class Service:
    name: str = ""
    port_label: str = ""
    provider: str = "consul"
    tags: List[str] = field(default_factory=list)
    checks: List[dict] = field(default_factory=list)
    # service mesh (reference: structs.ConsulConnect at structs/services.go):
    # {"sidecar_service": {"proxy": {"upstreams": [
    #     {"destination_name": ..., "local_bind_port": ...}]}}}
    # Admission injects the sidecar proxy task + its public port
    # (server/admission.py ConnectHook).
    connect: Optional[dict] = None


@dataclass
class ServiceRegistration:
    """One group or task service instance in the native service catalog
    (upstream: nomad/structs/service_registration.go
    ServiceRegistration): written as a workload starts, read through
    /v1/services, removed with its alloc or its node."""

    id: str = ""
    service_name: str = ""
    namespace: str = DEFAULT_NAMESPACE
    node_id: str = ""
    datacenter: str = ""
    job_id: str = ""
    alloc_id: str = ""
    provider: str = "nomad"
    tags: List[str] = field(default_factory=list)
    address: str = ""
    port: int = 0
    # simplified check health: pending | passing | failing
    status: str = "passing"
    create_index: int = 0
    modify_index: int = 0


@dataclass
class LogConfig:
    max_files: int = 10
    max_file_size_mb: int = 10


@dataclass
class Task:
    """One process of a task group (reference: structs.Task)."""

    name: str = ""
    driver: str = "mock"
    user: str = ""
    config: Dict[str, object] = field(default_factory=dict)
    env: Dict[str, str] = field(default_factory=dict)
    services: List[Service] = field(default_factory=list)
    constraints: List[Constraint] = field(default_factory=list)
    affinities: List[Affinity] = field(default_factory=list)
    resources: Resources = field(default_factory=Resources)
    leader: bool = False
    kill_timeout_s: float = 5.0
    log_config: LogConfig = field(default_factory=LogConfig)
    artifacts: List[dict] = field(default_factory=list)
    templates: List[dict] = field(default_factory=list)
    # volume_mount blocks (reference: structs.VolumeMount):
    # {"volume": <tg volume name>, "destination": path, "read_only": bool}
    volume_mounts: List[dict] = field(default_factory=list)
    vault: Optional[dict] = None
    # workload identity requirement (reference: structs.WorkloadIdentity);
    # injected by admission for secret-consuming tasks
    identity: Optional[dict] = None
    meta: Dict[str, str] = field(default_factory=dict)
    lifecycle: Optional[dict] = None   # {"hook": "prestart", "sidecar": False}
    kind: str = ""


@dataclass
class TaskGroup:
    """A co-scheduled set of tasks (reference: structs.TaskGroup)."""

    name: str = ""
    count: int = 1
    update: Optional[UpdateStrategy] = None
    migrate: Optional[MigrateStrategy] = None
    constraints: List[Constraint] = field(default_factory=list)
    scaling: Optional[dict] = None
    restart_policy: RestartPolicy = field(default_factory=RestartPolicy)
    reschedule_policy: Optional[ReschedulePolicy] = None
    tasks: List[Task] = field(default_factory=list)
    ephemeral_disk: EphemeralDisk = field(default_factory=EphemeralDisk)
    meta: Dict[str, str] = field(default_factory=dict)
    networks: List[NetworkResource] = field(default_factory=list)
    services: List[Service] = field(default_factory=list)
    volumes: Dict[str, VolumeRequest] = field(default_factory=dict)
    affinities: List[Affinity] = field(default_factory=list)
    spreads: List[Spread] = field(default_factory=list)
    max_client_disconnect_s: Optional[float] = None
    stop_after_client_disconnect_s: Optional[float] = None
    prevent_reschedule_on_lost: bool = False

    def lookup_task(self, name: str) -> Optional[Task]:
        for t in self.tasks:
            if t.name == name:
                return t
        return None

    def total_resources(self) -> Resources:
        """Sum of task asks + ephemeral disk -- the unit the bin-packer fits."""
        out = Resources(cpu=0, memory_mb=0, disk_mb=self.ephemeral_disk.size_mb)
        for t in self.tasks:
            out.cpu += t.resources.cpu
            out.cores += t.resources.cores
            out.memory_mb += t.resources.memory_mb
            out.memory_max_mb += (t.resources.memory_max_mb or t.resources.memory_mb)
            out.devices.extend(t.resources.devices)
        out.networks = list(self.networks)
        return out


@dataclass
class PeriodicConfig:
    """A periodic job's launch spec (reference: structs/job.py:382;
    upstream: structs.PeriodicConfig). The server's launcher reads
    ``@every <N>s`` specs."""

    enabled: bool = True
    spec: str = ""            # cron expression
    spec_type: str = "cron"
    prohibit_overlap: bool = False
    timezone: str = "UTC"


@dataclass
class ParameterizedJobConfig:
    """A parameterized job's dispatch contract (reference:
    structs/job.py:391; upstream: structs.ParameterizedJobConfig): what
    Server.dispatch_job checks a dispatch request against."""

    payload: str = "optional"     # optional | required | forbidden
    meta_required: List[str] = field(default_factory=list)
    meta_optional: List[str] = field(default_factory=list)


@dataclass
class Job:
    """The unit of submission (reference: structs.Job)."""

    id: str = ""
    name: str = ""
    namespace: str = DEFAULT_NAMESPACE
    region: str = "global"
    type: str = JOB_TYPE_SERVICE
    priority: int = JOB_DEFAULT_PRIORITY
    all_at_once: bool = False
    datacenters: List[str] = field(default_factory=lambda: ["*"])
    node_pool: str = DEFAULT_NODE_POOL
    constraints: List[Constraint] = field(default_factory=list)
    affinities: List[Affinity] = field(default_factory=list)
    spreads: List[Spread] = field(default_factory=list)
    task_groups: List[TaskGroup] = field(default_factory=list)
    update: Optional[UpdateStrategy] = None
    periodic: Optional[PeriodicConfig] = None
    parameterized: Optional[ParameterizedJobConfig] = None
    multiregion: Optional[object] = None
    payload: bytes = b""
    meta: Dict[str, str] = field(default_factory=dict)
    vault_namespace: str = ""
    status: str = JOB_STATUS_PENDING
    stop: bool = False
    stable: bool = False
    version: int = 0
    submit_time: int = 0
    create_index: int = 0
    modify_index: int = 0
    job_modify_index: int = 0
    # dispatch
    parent_id: str = ""
    dispatched: bool = False
    dispatch_idempotency_token: str = ""

    def lookup_task_group(self, name: str) -> Optional[TaskGroup]:
        for tg in self.task_groups:
            if tg.name == name:
                return tg
        return None

    def stopped(self) -> bool:
        return self.stop

    def is_periodic(self) -> bool:
        return self.periodic is not None

    def is_parameterized(self) -> bool:
        return self.parameterized is not None and not self.dispatched

    def ns_id(self):
        return (self.namespace, self.id)


@dataclass
class ScalingPolicy:
    """A task group's horizontal scaling policy, derived from the group's
    ``scaling`` block when the job is stored (reference: structs/job.py:460;
    upstream: structs.ScalingPolicy and the state store's
    updateJobScalingPolicies)."""

    id: str = ""
    namespace: str = DEFAULT_NAMESPACE
    job_id: str = ""
    type: str = "horizontal"
    # what the policy scales: {"Namespace": ns, "Job": id, "Group": group}
    target: Dict[str, str] = field(default_factory=dict)
    min: int = 0
    max: int = 0
    policy: Dict[str, object] = field(default_factory=dict)
    enabled: bool = True
    create_index: int = 0
    modify_index: int = 0


@dataclass
class ScalingEvent:
    """One entry of a job's scaling audit trail (reference:
    structs/job.py:482; upstream: structs.ScalingEvent, recorded by
    Job.Scale)."""

    time: float = 0.0
    task_group: str = ""
    count: Optional[int] = None
    previous_count: int = 0
    message: str = ""
    error: bool = False
    meta: Dict[str, object] = field(default_factory=dict)
    eval_id: str = ""
