"""Canned structs (port of nomad_tpu/mock.py; upstream: nomad/mock/node.go,
mock/job.go, mock/alloc.go): the worlds of chip_smoke.py and the tests
are built from these."""
from __future__ import annotations

import itertools

from .structs import (
    AllocatedResources, AllocatedSharedResources, AllocatedTaskResources,
    Allocation, EphemeralDisk, Evaluation, Job, NetworkResource, Node,
    NodeCpuResources, NodeDeviceResource, NodeDiskResources,
    NodeMemoryResources, NodeReservedResources, NodeResources, Resources,
    ReschedulePolicy, RestartPolicy, Task, TaskGroup, UpdateStrategy,
    generate_uuid, JOB_TYPE_BATCH, JOB_TYPE_SERVICE, JOB_TYPE_SYSTEM,
    NODE_STATUS_READY, ALLOC_CLIENT_PENDING, ALLOC_DESIRED_RUN,
    TRIGGER_JOB_REGISTER, EVAL_STATUS_PENDING,
)

_counter = itertools.count()


def node(**kw) -> Node:
    """A ready 4-core / 4 GHz / 8 GiB node."""
    n = Node(
        id=generate_uuid(),
        name=f"node-{next(_counter)}",
        datacenter="dc1",
        node_class="",
        attributes={
            "kernel.name": "linux",
            "arch": "amd64",
            "nomad.version": "0.1.0",
            "driver.mock": "1",
            "cpu.numcores": "4",
        },
        node_resources=NodeResources(
            cpu=NodeCpuResources(cpu_shares=4000, total_core_count=4,
                                 reservable_cores=[0, 1, 2, 3]),
            memory=NodeMemoryResources(memory_mb=8192),
            disk=NodeDiskResources(disk_mb=100 * 1024),
            networks=[NetworkResource(mode="host", device="eth0",
                                      cidr="192.168.0.100/32",
                                      ip="192.168.0.100")],
        ),
        reserved_resources=NodeReservedResources(
            cpu_shares=0, memory_mb=0, disk_mb=0),
        status=NODE_STATUS_READY,
    )
    for k, v in kw.items():
        setattr(n, k, v)
    n.compute_class()
    return n


def gpu_node(count: int = 4, **kw) -> Node:
    n = node(**kw)
    n.node_resources.devices = [NodeDeviceResource(
        vendor="nvidia", type="gpu", name="1080ti",
        instance_ids=[generate_uuid() for _ in range(count)],
        attributes={"memory": 11 * 1024, "cuda_cores": 3584},
    )]
    n.compute_class()
    return n


def job(**kw) -> Job:
    """10-instance service job, 1 TG, 1 task, 500 MHz / 256 MB / 150 MB
    of disk."""
    j = Job(
        id=f"mock-service-{generate_uuid()}",
        name="my-job",
        type=JOB_TYPE_SERVICE,
        priority=50,
        datacenters=["dc1"],
        task_groups=[TaskGroup(
            name="web",
            count=10,
            ephemeral_disk=EphemeralDisk(size_mb=150),
            restart_policy=RestartPolicy(attempts=3, interval_s=600,
                                         delay_s=1, mode="delay"),
            reschedule_policy=ReschedulePolicy(
                attempts=2, interval_s=600, delay_s=5,
                delay_function="constant", unlimited=False),
            update=UpdateStrategy(max_parallel=1, health_check="checks"),
            tasks=[Task(
                name="web",
                driver="mock",
                config={"run_for": "30s"},
                resources=Resources(cpu=500, memory_mb=256),
            )],
        )],
        status="pending",
        version=0,
        create_index=42,
        modify_index=99,
        job_modify_index=99,
    )
    for k, v in kw.items():
        setattr(j, k, v)
    return j


def batch_job(count: int = 10, **kw) -> Job:
    j = job()
    j.type = JOB_TYPE_BATCH
    j.task_groups[0].count = count
    j.update = None
    j.task_groups[0].update = None
    for k, v in kw.items():
        setattr(j, k, v)
    return j


def system_job(**kw) -> Job:
    j = job()
    j.type = JOB_TYPE_SYSTEM
    j.priority = 100
    j.task_groups[0].count = 1
    j.task_groups[0].update = None
    j.task_groups[0].reschedule_policy = None
    for k, v in kw.items():
        setattr(j, k, v)
    return j


def evaluation(**kw) -> Evaluation:
    e = Evaluation(
        id=generate_uuid(),
        namespace="default",
        priority=50,
        type=JOB_TYPE_SERVICE,
        job_id=generate_uuid(),
        status=EVAL_STATUS_PENDING,
        triggered_by=TRIGGER_JOB_REGISTER,
    )
    for k, v in kw.items():
        setattr(e, k, v)
    return e


def alloc_for(j: Job, n: Node, index: int = 0, tg_name: str = ""
              ) -> Allocation:
    """An allocation of job j's first (or named) task group on node n."""
    tg = j.lookup_task_group(tg_name) if tg_name else j.task_groups[0]
    tasks = {}
    for t in tg.tasks:
        tasks[t.name] = AllocatedTaskResources(
            cpu_shares=t.resources.cpu,
            memory_mb=t.resources.memory_mb,
        )
    return Allocation(
        id=generate_uuid(),
        eval_id=generate_uuid(),
        name=f"{j.id}.{tg.name}[{index}]",
        node_id=n.id,
        job_id=j.id,
        job=j,
        task_group=tg.name,
        allocated_resources=AllocatedResources(
            tasks=tasks,
            shared=AllocatedSharedResources(
                disk_mb=tg.ephemeral_disk.size_mb),
        ),
        desired_status=ALLOC_DESIRED_RUN,
        client_status=ALLOC_CLIENT_PENDING,
        job_version=j.version,
    )
