"""The port's eval broker and blocked evals (server/broker.py) and the
worker's lease fence (server/worker.py WorkerPlanner) held against the
JAX package's on the CPU.

Each scenario of tests/test_churn_storm.py's broker half,
tests/test_batch_worker.py's distinct-jobs dequeue and
tests/test_worker_pool.py's lease, fence and quarantine drills runs once
through each package with the same evals (fixed ids); what it observes
-- the broker's stats, the dequeued eval ids in order, the tokens' fate,
the quarantine state -- must be equal, and the scenario's own
assertions hold for the port. The knobs are set in both spellings.
Every wait has a deadline.
"""
import time
from types import SimpleNamespace

import pytest

from nomad_tpu import mock as ref_mock
from nomad_tpu import structs as ref_structs
from nomad_tpu.server import Server as RefServer
from nomad_tpu.server import broker as ref_broker
from nomad_tpu.server import worker as ref_worker
from nomad_tpu.structs.job import reseed_ids as ref_reseed_ids

from nomad_tpu_torch import mock as port_mock
from nomad_tpu_torch import structs as port_structs
from nomad_tpu_torch.server import Server as PortServer
from nomad_tpu_torch.server import broker as port_broker
from nomad_tpu_torch.server import worker as port_worker

REF = SimpleNamespace(mock=ref_mock, st=ref_structs, broker=ref_broker,
                      worker=ref_worker, reseed=ref_reseed_ids,
                      server=lambda: RefServer(num_workers=0,
                                               heartbeat_ttl=60.0))
PORT = SimpleNamespace(mock=port_mock, st=port_structs, broker=port_broker,
                       worker=port_worker, reseed=port_structs.reseed_ids,
                       server=lambda: PortServer(num_workers=2,
                                                 device="cpu"))


def setenv(monkeypatch, name, value):
    monkeypatch.setenv(f"NOMAD_TPU_{name}", value)
    monkeypatch.setenv(f"NOMAD_TPU_TORCH_{name}", value)


def both(scenario, *args):
    want = scenario(REF, *args)
    got = scenario(PORT, *args)
    assert got == want
    return got


def wait_until(cond, timeout=15.0, msg="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timeout waiting for {msg}")


def mk_eval(P, i, job_id=None):
    ev = P.mock.evaluation(job_id=job_id or f"storm-job-{i:05d}")
    ev.id = f"storm-eval-{i:030d}"
    return ev


def stats(b):
    s = b.stats()
    return {k: s[k] for k in ("total_ready", "total_unacked",
                              "total_waiting", "total_delayed",
                              "total_failed", "total_quarantined")}


def drain(b, n, deadline_s=10.0):
    """Dequeue and ack until ``n`` distinct evals came; their ids in
    order."""
    got = []
    deadline = time.time() + deadline_s
    while len(set(got)) < n and time.time() < deadline:
        ev, token = b.dequeue(["service"], timeout=0.5)
        if ev is not None:
            got.append(ev.id)
            assert b.ack(ev.id, token) is None
    return got


# --------------------------------------------------------------------------
# tests/test_batch_worker.py, tests/test_churn_storm.py

def distinct_jobs(P):
    b = P.broker.EvalBroker()
    b.set_enabled(True)
    try:
        for i in range(5):
            b.enqueue(mk_eval(P, i, job_id=f"job-{i % 3}"))
        batch = b.dequeue_batch(["service"], max_k=10, timeout=0.5)
        out = [ev.id for ev, _ in batch]
        for ev, token in batch:
            assert b.ack(ev.id, token) is None
        # the acks promoted the two waiting evals of jobs 0 and 1
        return out, stats(b), [ev.id for ev, _ in b.dequeue_batch(
            ["service"], max_k=10, timeout=0.5)]
    finally:
        b.shutdown()


def test_dequeue_batch_distinct_jobs():
    first, _, second = both(distinct_jobs)
    assert len(first) == 3 and len(second) == 2


def storm_wave(P):
    b = P.broker.EvalBroker()
    b.storm_wave, b.storm_rate = 4, 1000.0
    b.set_enabled(True)
    try:
        b.enqueue_storm([mk_eval(P, i) for i in range(10)])
        first = stats(b)
        return first, sorted(drain(b, 10))
    finally:
        b.shutdown()


def test_enqueue_storm_admits_one_wave_defers_rest():
    first, got = both(storm_wave)
    assert first["total_ready"] == 4 and first["total_delayed"] == 6
    assert len(got) == 10


def storm_killswitch(P):
    b = P.broker.EvalBroker()
    b.set_enabled(True)
    try:
        b.enqueue_storm([mk_eval(P, i) for i in range(10)])
        return stats(b)
    finally:
        b.shutdown()


def test_enqueue_storm_killswitch_restores_immediate(monkeypatch):
    setenv(monkeypatch, "STORM_ADMISSION", "0")
    st = both(storm_killswitch)
    assert st["total_ready"] == 10 and st["total_delayed"] == 0


def ready_shedding(P):
    b = P.broker.EvalBroker()
    b.max_ready, b.shed_delay_s = 5, 0.1
    b.set_enabled(True)
    try:
        b.enqueue_all([mk_eval(P, i) for i in range(9)])
        first = stats(b)
        return first, sorted(drain(b, 9))
    finally:
        b.shutdown()


def test_ready_depth_shedding_defers_not_drops():
    first, got = both(ready_shedding)
    assert first["total_ready"] == 5 and first["total_delayed"] == 4
    assert len(got) == 9


def node_fanout(P):
    P.reseed(77)
    server = P.server()
    server.start()
    try:
        # this drill reads the broker's depths: no worker may dequeue
        workers = list(server.workers)
        for w in workers:
            w.stop()
        for w in workers:
            w.join(10.0)
        assert not any(w.is_alive() for w in workers)
        server.broker.storm_wave = 3
        server.broker.storm_rate = 0.5
        n = P.mock.node()
        n.id = "fan-node-0001"
        n.compute_class()
        server.register_node(n)
        for i in range(8):
            job = P.mock.job(id=f"fan-{i}")
            server.state.upsert_job(job)
            a = P.mock.alloc_for(job, n)
            a.client_status = "running"
            server.state.upsert_allocs([a])
        server.update_node_status(n.id, "down")
        st = stats(server.broker)
        assert st["total_ready"] <= 3
        assert st["total_ready"] + st["total_delayed"] == 8
        return st, server.state.node_by_id(n.id).status
    finally:
        server.shutdown()


def test_node_fanout_rides_storm_admission():
    """A node-down fan-out larger than the wave lands part ready, part
    deferred through Server._create_node_evals."""
    both(node_fanout)


# --------------------------------------------------------------------------
# tests/test_worker_pool.py: leases, the fence, the quarantine

def lapse(b, ev_id):
    deadline = b._unack[ev_id][2]
    wait_until(lambda: time.time() > deadline, msg="lease lapsed")


def lease_redelivery(P):
    b = P.broker.EvalBroker(nack_timeout=0.05)
    b.set_enabled(True)
    try:
        ev = P.mock.evaluation(job_id="wp-lease-job")
        ev.id = "wp-lease-eval-0001"
        b.enqueue(ev)
        got, tok1 = b.dequeue(["service"], timeout=2.0)
        assert got is not None and got.id == ev.id
        lapse(b, ev.id)
        b.nack_timeout = 30.0
        got2, tok2 = b.dequeue(["service"], timeout=2.0)
        assert got2 is not None and got2.id == ev.id and tok2 != tok1
        none, _ = b.dequeue(["service"], timeout=0.2)
        return (none, tok1, tok2, b.token_outstanding(ev.id, tok1),
                b.token_outstanding(ev.id, tok2),
                b.ack(ev.id, tok1) is not None, b.ack(ev.id, tok2))
    finally:
        b.shutdown()


def test_lease_redelivery_replacement_races_nack_sweep():
    """A lapsed lease redelivers exactly once: the stale token bounces,
    the fresh one acks."""
    assert both(lease_redelivery)[3:] == (False, True, True, None)


def stale_fence(P):
    b = P.broker.EvalBroker(nack_timeout=0.05)
    b.set_enabled(True)
    try:
        ev = P.mock.evaluation(job_id="wp-fence-job")
        ev.id = "wp-fence-eval-0001"
        b.enqueue(ev)
        _, tok1 = b.dequeue(["service"], timeout=2.0)
        lapse(b, ev.id)
        b.nack_timeout = 30.0
        _, tok2 = b.dequeue(["service"], timeout=2.0)
        shim = SimpleNamespace(broker=b)    # the fence reads only this
        zombie = P.worker.WorkerPlanner(shim, tok1, eval_id=ev.id,
                                        worker_name="zombie-worker")
        with pytest.raises(P.worker.StaleEvalToken):
            zombie.submit_plan(P.st.Plan(eval_id=ev.id, job=P.mock.job()))
        return b.token_outstanding(ev.id, tok2), b.ack(ev.id, tok2)
    finally:
        b.shutdown()


def test_stale_lease_fence_rejects_zombie_plan():
    assert both(stale_fence) == (True, None)


def burn_cycles(b, ev_id, until, deadline_s=15.0):
    deadline = time.time() + deadline_s
    while time.time() < deadline and not until():
        got, tok = b.dequeue(["service"], timeout=0.25)
        if got is not None:
            assert got.id == ev_id
            b.nack(got.id, tok)
    return until()


def poison(P):
    b = P.broker.EvalBroker(nack_timeout=0.05, delivery_limit=2)
    b.set_enabled(True)
    try:
        ev = P.mock.evaluation(job_id="wp-poison-job")
        ev.id = "wp-poison-eval-001"
        b.enqueue(ev)
        assert burn_cycles(b, ev.id,
                           lambda: b.quarantine_state()["total"] == 1)
        qs = b.quarantine_state()
        out = [[(e["id"], e["strikes"], e["job_id"]) for e in qs["evals"]],
               stats(b)["total_quarantined"]]
        b.enqueue(ev)               # dead-lettered: ignored
        got, _ = b.dequeue(["service"], timeout=0.3)
        out.append(got)
        out.append(b.release_quarantined(ev.id))
        got, tok = b.dequeue(["service"], timeout=2.0)
        out += [got.id, b.ack(ev.id, tok), dict(b._poison_strikes)]
        return out
    finally:
        b.shutdown()


def test_poison_eval_quarantined_then_released(monkeypatch):
    setenv(monkeypatch, "POISON_AFTER", "2")
    out = both(poison)
    assert out == [[("wp-poison-eval-001", 2, "wp-poison-job")], 1, None,
                   ["wp-poison-eval-001"], "wp-poison-eval-001", None, {}]


def no_poison(P):
    b = P.broker.EvalBroker(nack_timeout=0.05, delivery_limit=2)
    b.set_enabled(True)
    try:
        ev = P.mock.evaluation(job_id="wp-nopoison-job")
        ev.id = "wp-nopoison-eval-01"
        b.enqueue(ev)
        assert burn_cycles(b, ev.id,
                           lambda: b._poison_strikes.get(ev.id, 0) >= 3)
        total = b.quarantine_state()["total"]
        got, tok = b.dequeue(["service"], timeout=2.0)
        return total, got.id, b.ack(ev.id, tok)
    finally:
        b.shutdown()


def test_poison_after_zero_disables_quarantine(monkeypatch):
    setenv(monkeypatch, "POISON_AFTER", "0")
    assert both(no_poison) == (0, "wp-nopoison-eval-01", None)


def blocked_unblock(P):
    """BlockedEvals keeps the newest blocked eval per job and releases by
    computed class (escaped evals on any class)."""
    b = P.broker.EvalBroker()
    b.set_enabled(True)
    blocked = P.broker.BlockedEvals(b)
    blocked.set_enabled(True)
    try:
        out = []
        for i, (cls, elig, escaped) in enumerate((
                ("v1:a", {"v1:a": False}, False),
                ("v1:b", {"v1:b": True}, False),
                ("v1:c", {}, True))):
            ev = mk_eval(P, i)
            ev.status = "blocked"
            ev.class_eligibility = dict(elig)
            ev.escaped_computed_class = escaped
            blocked.block(ev)
        out.append(blocked.stats())
        out.append(sorted(e.id for e in blocked.unblock("v1:a")))
        out.append(sorted(e.id for e in blocked.unblock("v1:b")))
        out.append(blocked.stats())
        got = []
        while True:
            ev, tok = b.dequeue(["service"], timeout=0.1)
            if ev is None:
                break
            got.append((ev.id, ev.status, ev.triggered_by))
            b.ack(ev.id, tok)
        out.append(sorted(got))
        return out
    finally:
        b.shutdown()


def test_blocked_evals_unblock_by_class():
    out = both(blocked_unblock)
    # v1:a releases the eval that never saw v1:a and the escaped one;
    # the eval ineligible on v1:a waits for another class
    assert out[0]["total_blocked"] == 3
    assert out[1] == [f"storm-eval-{i:030d}" for i in (1, 2)]
    assert out[2] == [f"storm-eval-{0:030d}"]
    assert out[3]["total_blocked"] == 0 and len(out[4]) == 3
