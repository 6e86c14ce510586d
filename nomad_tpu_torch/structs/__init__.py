"""The data model the scheduler and the placement service read (port of
the scheduling half of nomad_tpu/structs/): resources, ports, nodes,
jobs, allocations, evaluations, deployments, plans, plan results, the
scheduler configuration and namespaces. Class and field names equal the
reference's, so carry.struct_from_reference can map a reference struct
onto its port class by name."""
from . import codec  # noqa: F401
from .resources import (  # noqa: F401
    AllocatedDeviceResource, AllocatedPortMapping, AllocatedResources,
    AllocatedSharedResources, AllocatedTaskResources, ComparableResources,
    DeviceRequest, NetworkResource, NodeCpuResources, NodeDeviceResource,
    NodeDiskResources, NodeMemoryResources, NodeReservedResources,
    NodeResources, Port, Resources,
    DEFAULT_MIN_DYNAMIC_PORT, DEFAULT_MAX_DYNAMIC_PORT,
)
from .job import (  # noqa: F401
    Affinity, Constraint, EphemeralDisk, Job, LogConfig, MigrateStrategy,
    ParameterizedJobConfig, PeriodicConfig, ReschedulePolicy, RestartPolicy, Service, Spread, SpreadTarget, Task,
    TaskGroup, UpdateStrategy, VolumeRequest, generate_uuid, reseed_ids,
    JOB_TYPE_SERVICE, JOB_TYPE_BATCH, JOB_TYPE_SYSTEM, JOB_TYPE_SYSBATCH,
    JOB_STATUS_PENDING, JOB_STATUS_RUNNING, JOB_STATUS_DEAD,
    JOB_DEFAULT_PRIORITY, JOB_MAX_PRIORITY,
    CONSTRAINT_DISTINCT_HOSTS, CONSTRAINT_DISTINCT_PROPERTY, CONSTRAINT_REGEX,
    CONSTRAINT_VERSION, CONSTRAINT_SEMVER, CONSTRAINT_SET_CONTAINS,
    CONSTRAINT_SET_CONTAINS_ALL, CONSTRAINT_SET_CONTAINS_ANY,
    CONSTRAINT_ATTR_IS_SET, CONSTRAINT_ATTR_IS_NOT_SET,
    DEFAULT_NAMESPACE, DEFAULT_NODE_POOL,
)
from .node import (  # noqa: F401
    ClientHostVolumeConfig, DrainStrategy, DriverInfo, Node, NodePool,
    NODE_STATUS_INIT, NODE_STATUS_READY, NODE_STATUS_DOWN,
    NODE_STATUS_DISCONNECTED, NODE_SCHED_ELIGIBLE, NODE_SCHED_INELIGIBLE,
)
from .alloc import (  # noqa: F401
    AllocDeploymentStatus, AllocMetric, Allocation, Deployment,
    DeploymentState, DeploymentStatusUpdate, DesiredTransition, Evaluation,
    NetworkStatus, Plan, RescheduleEvent, RescheduleTracker,
    ALLOC_DESIRED_RUN, ALLOC_DESIRED_STOP, ALLOC_DESIRED_EVICT,
    ALLOC_CLIENT_PENDING, ALLOC_CLIENT_RUNNING, ALLOC_CLIENT_COMPLETE,
    ALLOC_CLIENT_FAILED, ALLOC_CLIENT_LOST, ALLOC_CLIENT_UNKNOWN,
    EVAL_STATUS_BLOCKED, EVAL_STATUS_PENDING, EVAL_STATUS_COMPLETE,
    EVAL_STATUS_FAILED, EVAL_STATUS_CANCELLED,
    TRIGGER_JOB_REGISTER, TRIGGER_JOB_DEREGISTER, TRIGGER_PERIODIC_JOB,
    TRIGGER_NODE_DRAIN, TRIGGER_NODE_UPDATE, TRIGGER_ALLOC_STOP,
    TRIGGER_SCHEDULED, TRIGGER_ROLLING_UPDATE, TRIGGER_DEPLOYMENT_WATCHER,
    TRIGGER_FAILED_FOLLOW_UP, TRIGGER_MAX_DISCONNECT_TIMEOUT,
    TRIGGER_RECONNECT, TRIGGER_RETRY_FAILED_ALLOC, TRIGGER_QUEUED_ALLOCS,
    TRIGGER_PREEMPTION, TRIGGER_SCALING,
    DEPLOYMENT_STATUS_RUNNING, DEPLOYMENT_STATUS_PAUSED,
    DEPLOYMENT_STATUS_FAILED, DEPLOYMENT_STATUS_SUCCESSFUL,
    DEPLOYMENT_STATUS_CANCELLED, PlanResult,
)
from .network import NetworkIndex, PortBitmap, AssignedPorts  # noqa: F401
from .funcs import (  # noqa: F401
    allocs_fit, devices_fit, compute_free_percentage, score_fit_binpack,
    score_fit_spread, BINPACK_MAX_FIT_SCORE,
)
from .config import (  # noqa: F401
    Namespace, NamespaceNodePoolConfiguration, PreemptionConfig,
    SchedulerConfiguration,
    SCHED_ALG_BINPACK, SCHED_ALG_SPREAD, SCHED_ALG_TPU_BINPACK,
    SCHED_ALG_TPU_LPQ, SCHED_ALG_TPU_SPREAD,
)
