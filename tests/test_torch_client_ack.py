"""``Server.update_allocs_from_client`` (the client's alloc status
acknowledgement, server/core.py and state/store.py) held against the JAX
package's on the CPU.

Both Servers run on one world: register, deregister, then the client
acknowledges the stops. Capacity a stopped alloc held frees only on that
acknowledgement (the scheduler's liveness filter keeps a stopped alloc
until its client says it is terminal), the job's status is refreshed,
and the next round places the same in both. A failed acknowledgement
enqueues one ``alloc-failure`` eval, whose reschedule lane carries the
failed node's penalty, so the port solves it through row 2's kernel
(solver/wave.py wave_compact: its plain version on the CPU).

Every id a call mints comes from both id streams reseeded alike; every
wait has a deadline, and both servers are shut down."""
import contextlib
import copy

import numpy as np
import pytest

from nomad_tpu import mock
from nomad_tpu.server import Server as RefServer
from nomad_tpu.state import StateStore as RefStateStore
from nomad_tpu.structs import ReschedulePolicy as RefReschedulePolicy
from nomad_tpu.structs import SchedulerConfiguration
from nomad_tpu.structs.job import reseed_ids as ref_reseed_ids

from nomad_tpu_torch import mock as pmock
from nomad_tpu_torch import structs as pst
from nomad_tpu_torch.carry import store_from_reference
from nomad_tpu_torch.server import Server
from nomad_tpu_torch.solver import wave

from test_torch_server import (  # noqa: F401
    assert_same, fresh_state, settled, wait_until)
from test_torch_telemetry import reset_globals

ACK_TIME = 1_700_000_000.0


@pytest.fixture(autouse=True)
def fresh_telemetry():
    reset_globals()
    yield
    reset_globals()


@contextlib.contextmanager
def ack_pair(n_nodes=6, cpu=4000, mem=8192, **kw):
    """A reference Server and a port Server (device="cpu") on one world
    of ``n_nodes`` nodes under tpu-binpack, plain workers by default
    (one eval at a time)."""
    ref_reseed_ids(9)
    store = RefStateStore()
    store.set_scheduler_config(SchedulerConfiguration(
        scheduler_algorithm="tpu-binpack"))
    for i in range(n_nodes):
        n = mock.node()
        n.id = f"ack-node-{i:04d}"
        n.node_resources.cpu.cpu_shares = cpu
        n.node_resources.memory.memory_mb = mem
        n.compute_class()
        store.upsert_node(n)
    kw = dict(dict(num_workers=2, eval_batching=False), **kw)
    ref = RefServer(state=store, heartbeat_ttl=3600.0, **kw)
    port = None
    try:
        ref.start()
        port = Server(state=store_from_reference(store.snapshot()),
                      device="cpu", heartbeat_ttl=3600.0, **kw)
        port.start()
        yield ref, port
    finally:
        ref.shutdown()
        if port is not None:
            port.shutdown()


SERVERS = (("ref", mock, ref_reseed_ids), ("port", pmock, pst.reseed_ids))


def each(ref, port):
    """(server, mock module, reseed) for the reference, then the port."""
    return [(s, m, r) for s, (_, m, r) in zip((ref, port), SERVERS)]


def register(ref, port, job_id, count, seed, cpu=500, mem=256,
             reschedule_now=False):
    for server, m, reseed in each(ref, port):
        reseed(seed)
        job = m.job(id=job_id)
        tg = job.task_groups[0]
        tg.count = count
        tg.tasks[0].resources.cpu = cpu
        tg.tasks[0].resources.memory_mb = mem
        if reschedule_now:
            pol = RefReschedulePolicy if m is mock else pst.ReschedulePolicy
            tg.reschedule_policy = pol(
                attempts=2, interval_s=600, delay_s=0,
                delay_function="constant", unlimited=False)
        ev = server.register_job(job)
        wait_until(lambda s=server, e=ev: settled(s, [e.id]),
                   msg=f"{job_id} placed")


def deregister(ref, port, job_id, seed):
    for server, _, reseed in each(ref, port):
        reseed(seed)
        ev = server.deregister_job("default", job_id)
        wait_until(lambda s=server, e=ev: settled(s, [e.id]),
                   msg=f"{job_id} stopped")


def acks(server, job_id, status, pick=None):
    """Client updates for the job's allocs (``pick`` filters them)."""
    out = []
    for a in sorted(server.state.allocs_by_job("default", job_id),
                    key=lambda a: a.name):
        if pick is not None and not pick(a):
            continue
        upd = copy.copy(a)
        upd.client_status = status
        upd.client_description = f"client says {status}"
        upd.client_terminal_time = ACK_TIME
        out.append(upd)
    return out


def store_digest(server):
    """Every alloc (live or not) with its statuses, and every job's
    status: what the acknowledgement writes."""
    allocs = sorted((a.name, a.node_id, a.desired_status, a.client_status,
                     a.client_description, a.client_terminal_time,
                     bool(a.previous_allocation))
                    for a in server.state.allocs())
    jobs = sorted((j.id, j.status, j.stop) for j in server.state.jobs())
    return allocs, jobs


def usage(server):
    return {nid: tuple(round(x, 9) for x in v)
            for nid, v in server.state.quality_usage_by_node().items()}


def test_stop_acks_free_capacity_and_refresh_the_job():
    with ack_pair() as (ref, port):
        register(ref, port, "ack-old", 8, 55)
        assert_same(ref, port)
        held = usage(port)
        assert held == usage(ref) and held
        deregister(ref, port, "ack-old", 56)
        # stopped but not acknowledged: the capacity is still held
        assert usage(port) == held
        for server, _, _ in each(ref, port):
            server.update_allocs_from_client(
                acks(server, "ack-old", "complete",
                     pick=lambda a: a.desired_status != "run"))
        freed = usage(port)
        assert freed == usage(ref) and set(freed) == set(held)
        assert all(v == (0.0, 0.0, 0.0) for v in freed.values())
        assert store_digest(port) == store_digest(ref)
        job = port.state.job_by_id("default", "ack-old")
        assert job.status == "dead" and job.stop
        # the next round places against the freed fleet, the same in both
        register(ref, port, "ack-new", 12, 57, cpu=1500)
        got = assert_same(ref, port)
        assert len([a for a in got["allocs"] if a[2] == "ack-new"]) == 12
        assert store_digest(port) == store_digest(ref)
        assert usage(port) == usage(ref)


def test_unknown_and_running_acks_change_nothing_but_statuses():
    with ack_pair(n_nodes=3) as (ref, port):
        register(ref, port, "ack-run", 3, 60)
        idx = [s.state.latest_index() for s, _, _ in each(ref, port)]
        for server, _, _ in each(ref, port):
            ups = acks(server, "ack-run", "running")
            ghost = copy.copy(ups[0])
            ghost.id = "no-such-alloc"
            server.update_allocs_from_client(ups + [ghost])
        assert [s.state.latest_index() for s, _, _ in each(ref, port)] == [
            i + 1 for i in idx]
        assert store_digest(port) == store_digest(ref)
        assert usage(port) == usage(ref)
        assert port.state.job_by_id("default", "ack-run").status == \
            "running"
        assert not port.broker.stats()["total_ready"]


def test_failed_ack_enqueues_the_alloc_failure_reschedule(monkeypatch):
    """A failed alloc's acknowledgement enqueues one alloc-failure eval
    in each; its reschedule lane carries the failed node's penalty, so
    the port solves it through wave_compact (row 2), and both place the
    replacement alike, off the failed node."""
    calls = []
    compact = wave.wave_compact

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return compact(*a, **kw)

    monkeypatch.setattr(wave, "wave_compact", counted)
    with ack_pair(n_nodes=5) as (ref, port):
        register(ref, port, "ack-fail", 4, 61, reschedule_now=True)
        assert_same(ref, port)
        victim = sorted(port.state.allocs_by_job("default", "ack-fail"),
                        key=lambda a: a.name)[0]
        before = len(calls)
        for server, _, reseed in each(ref, port):
            reseed(62)
            server.update_allocs_from_client(
                acks(server, "ack-fail", "failed",
                     pick=lambda a: a.name == victim.name))
            evs = [e for e in server.state.evals()
                   if e.triggered_by == "alloc-failure"]
            assert len(evs) == 1
            wait_until(lambda s=server, e=evs[0]: settled(s, [e.id])
                       and len([a for a in s.state.allocs_by_job(
                           "default", "ack-fail")
                           if not a.client_terminal_status()]) == 4,
                       msg="rescheduled")
        got = assert_same(ref, port)
        assert store_digest(port) == store_digest(ref)
        assert len(calls) > before, "the reschedule lane took another route"
        repl = [a for a in port.state.allocs_by_job("default", "ack-fail")
                if a.previous_allocation == victim.id]
        assert len(repl) == 1 and repl[0].node_id != victim.node_id
        assert [e for e in got["evals"] if e[2] == "alloc-failure"]
        assert usage(port) == usage(ref)
        np.testing.assert_equal(len(port.state.evals()),
                                len(ref.state.evals()))
