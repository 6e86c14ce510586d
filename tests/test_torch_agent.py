"""The port's node side and dev agent on the CPU: SimClient
(nomad_tpu_torch/client/agent.py), the fingerprinters
(client/fingerprint.py, client/numalib.py), the agent config
(api/config.py) and the dev agent (api/devagent.py).

The SimClient scenarios of tests/test_server_e2e.py (a service job, a
batch job to completion, a node failure, a job stop, a failed alloc
rescheduled, a blocked eval released by a new node) run on a reference
cluster (reference Server, three reference SimClients) and on a port
cluster (port Server on device="cpu", three port SimClients), both with
tpu-binpack and a 1 s heartbeat TTL; each scenario's end state (allocs
by task group, client and desired status; the job's status; the
deployment's) is compared, exactly. The clients' timing decides which
node a replacement lands on, so nodes are not compared.

The dev agent runs as a subprocess with ``--device cpu --port 0``: its
printed address serves the API, its simulated nodes register, a job
runs to completion, SIGTERM ends it with exit 0; without ``--device``
on this CPU-only machine it exits non-zero with the device's reason.
The accelerator fingerprinter reads two fake cards and no card through
a monkeypatched ``torch.cuda``; probing is off unless asked. The
profiler endpoint on a CPU agent writes a chrome trace and refuses a
second start and a stop without one.
"""
import itertools
import json
import os
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from nomad_tpu import mock
from nomad_tpu.client import SimClient as RefSimClient
from nomad_tpu.server import Server as RefServer
from nomad_tpu.structs import SchedulerConfiguration as RefSchedConfig
from nomad_tpu.structs.job import reseed_ids as ref_reseed_ids

from nomad_tpu_torch import mock as pmock
from nomad_tpu_torch import structs as pst
from nomad_tpu_torch.api.client import ApiClient, ApiError
from nomad_tpu_torch.api.config import parse_agent_config
from nomad_tpu_torch.api.http import to_jsonable
from nomad_tpu_torch.client import FingerprintManager, SimClient
from nomad_tpu_torch.client import fingerprint, numalib
from nomad_tpu_torch.jobspec import HclError
from nomad_tpu_torch.server import Server

from chip_smoke import AgentProcess
from test_torch_http import agents, settled
from test_torch_server import wait_until
from test_torch_telemetry import reset_globals

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def fresh_telemetry():
    reset_globals()
    yield
    reset_globals()


class Cluster:
    """A Server (reference or port) with three SimClients."""

    def __init__(self, kind, seed):
        self.kind = kind
        if kind == "ref":
            ref_reseed_ids(seed)
            mock._counter = itertools.count()
            self.mock, self.client_cls = mock, RefSimClient
            self.server = RefServer(num_workers=2, heartbeat_ttl=1.0)
            self.server.state.set_scheduler_config(RefSchedConfig(
                scheduler_algorithm="tpu-binpack"))
        else:
            pst.reseed_ids(seed)
            pmock._counter = itertools.count()
            self.mock, self.client_cls = pmock, SimClient
            self.server = Server(num_workers=2, heartbeat_ttl=1.0,
                                 device="cpu")
            self.server.state.set_scheduler_config(pst.SchedulerConfiguration(
                scheduler_algorithm="tpu-binpack"))
        self.server.start()
        self.clients = [self.add_client() for _ in range(3)]
        wait_until(lambda: len(self.server.state.nodes()) == 3,
                   msg="nodes registered")

    def add_client(self):
        c = self.client_cls(self.server, self.mock.node())
        c.start()
        return c

    def close(self):
        for c in self.clients:
            c.stop()
        for c in self.clients:
            c.join(timeout=10.0)
        self.server.shutdown()

    def running(self, job):
        return [a for a in self.server.state.allocs_by_job(
            job.namespace, job.id)
            if a.client_status == "running" and a.desired_status == "run"]

    def end_state(self, job):
        st = self.server.state
        allocs = Counter((a.task_group, a.client_status, a.desired_status)
                         for a in st.allocs_by_job(job.namespace, job.id))
        j = st.job_by_id(job.namespace, job.id)
        d = st.latest_deployment_by_job(job.namespace, job.id)
        return (sorted(allocs.items()), j.status if j else None,
                d.status if d else None)


def scenario_service(c):
    job = c.mock.job()
    job.task_groups[0].count = 4
    job.task_groups[0].tasks[0].config = {}
    c.server.register_job(job)
    wait_until(lambda: len(c.running(job)) == 4, msg="4 running")
    wait_until(lambda: getattr(c.server.state.latest_deployment_by_job(
        job.namespace, job.id), "status", "") == "successful",
        msg="deployment successful")
    return job


def scenario_batch(c):
    job = c.mock.batch_job(count=3)
    job.task_groups[0].tasks[0].config = {"run_for": "0.3s"}
    c.server.register_job(job)
    wait_until(lambda: len([
        a for a in c.server.state.allocs_by_job(job.namespace, job.id)
        if a.client_status == "complete"]) == 3, msg="batch complete")
    wait_until(lambda: c.server.state.job_by_id(
        job.namespace, job.id).status == "dead", msg="batch job dead")
    return job


def scenario_node_failure(c):
    job = c.mock.job()
    job.task_groups[0].count = 3
    job.task_groups[0].tasks[0].config = {}
    c.server.register_job(job)
    wait_until(lambda: len(c.running(job)) == 3, msg="3 running")
    used = {a.node_id for a in c.running(job)}
    victim = next(cl for cl in c.clients if cl.node.id in used)
    n_lost = len([a for a in c.running(job) if a.node_id == victim.node.id])
    victim.freeze()
    wait_until(lambda: c.server.state.node_by_id(
        victim.node.id).status == "down", timeout=10.0, msg="node down")
    wait_until(lambda: len([a for a in c.running(job)
                            if a.node_id != victim.node.id]) == 3,
               timeout=15.0, msg="replaced")
    wait_until(lambda: len([
        a for a in c.server.state.allocs_by_job(job.namespace, job.id)
        if a.client_status == "lost"]) == n_lost, msg="lost marked")
    victim.thaw()
    c.lost = n_lost
    return job


def scenario_job_stop(c):
    job = c.mock.job()
    job.task_groups[0].count = 2
    job.task_groups[0].tasks[0].config = {}
    c.server.register_job(job)
    wait_until(lambda: len(c.running(job)) == 2, msg="2 running")
    c.server.deregister_job(job.namespace, job.id)
    wait_until(lambda: all(
        a.client_status == "complete"
        for a in c.server.state.allocs_by_job(job.namespace, job.id)),
        msg="all stopped")
    wait_until(lambda: c.server.state.job_by_id(
        job.namespace, job.id).status == "dead", msg="job dead")
    return job


def scenario_failed_rescheduled(c):
    job = c.mock.job()
    tg = job.task_groups[0]
    tg.count = 1
    tg.tasks[0].config = {"run_for": "0.2s", "exit_code": 1}
    tg.reschedule_policy.delay_s = 0.0
    tg.reschedule_policy.delay_function = "constant"
    tg.reschedule_policy.attempts = 1
    tg.reschedule_policy.interval_s = 300.0
    tg.reschedule_policy.unlimited = False
    c.server.register_job(job)
    # place, run, fail, reschedule once, fail again: attempts spent
    wait_until(lambda: len([
        a for a in c.server.state.allocs_by_job(job.namespace, job.id)
        if a.client_status == "failed"]) == 2, timeout=15.0,
        msg="both attempts failed")
    allocs = c.server.state.allocs_by_job(job.namespace, job.id)
    repl = [a for a in allocs if a.previous_allocation]
    assert len(repl) == 1 and repl[0].reschedule_tracker is not None
    return job


def scenario_blocked_released(c):
    job = c.mock.job()
    job.task_groups[0].count = 4
    job.task_groups[0].tasks[0].resources.cpu = 3500
    job.task_groups[0].tasks[0].config = {}
    c.server.register_job(job)
    wait_until(lambda: len(c.running(job)) == 3, msg="3 of 4 placed")
    assert c.server.blocked_evals.stats()["total_blocked"] >= 1
    c.clients.append(c.add_client())
    wait_until(lambda: len(c.running(job)) == 4, timeout=15.0,
               msg="4th placed on the new node")
    wait_until(lambda: c.server.blocked_evals.stats()["total_blocked"] == 0,
               msg="blocked eval released")
    return job


SCENARIOS = {"service": scenario_service, "batch": scenario_batch,
             "node-failure": scenario_node_failure,
             "job-stop": scenario_job_stop,
             "failed-rescheduled": scenario_failed_rescheduled,
             "blocked-released": scenario_blocked_released}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_sim_client_scenario_ends_as_the_reference(name):
    ends = {}
    for kind in ("ref", "port"):
        c = Cluster(kind, seed=200)
        try:
            job = SCENARIOS[name](c)
            ends[kind] = (c.end_state(job), getattr(c, "lost", None))
        finally:
            c.close()
    assert ends["port"] == ends["ref"]


# -- the dev agent as a process --------------------------------------------

def test_devagent_on_the_cpu_serves_the_api(tmp_path):
    agent = AgentProcess(["--device", "cpu", "--port", "0", "--nodes", "2",
                          "--tpu"], tmp_path)
    try:
        addr = agent.address(120.0)
        api = ApiClient(addr)
        wait_until(lambda: len(api.nodes()) == 2, timeout=30.0,
                   msg="simulated nodes")
        cfg = api.scheduler_config()
        assert cfg["scheduler_algorithm"] == "tpu-binpack"
        spec = tmp_path / "batch.nomad"
        spec.write_text("""
job "agent-batch" {
  type = "batch"
  group "g" {
    count = 2
    task "t" {
      driver = "mock"
      config { run_for = "100ms" }
      resources { cpu = 100 memory = 64 }
    }
  }
}
""")
        r = subprocess.run(
            [sys.executable, "-m", "nomad_tpu_torch.cli", "-address", addr,
             "job", "run", str(spec)], cwd=ROOT, capture_output=True,
            text=True, timeout=120)
        assert r.returncode == 0 and "Evaluation" in r.stdout, r.stderr
        wait_until(lambda: [a["client_status"] for a in
                            api.job_allocations("agent-batch")] ==
                   ["complete", "complete"], timeout=30.0,
                   msg="batch allocs complete")
        self_info = api.get("/v1/agent/self")
        assert self_info["stats"]["solver_guard"]["dispatch"]["ok"] >= 1
    finally:
        rc = agent.stop()
    assert rc == 0


def test_devagent_without_a_card_exits_non_zero():
    """No --device: the card is asked for, and this machine has none."""
    r = subprocess.run(
        [sys.executable, "-m", "nomad_tpu_torch.api.devagent", "--port",
         "0", "--nodes", "1"], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    assert r.returncode != 0
    assert "torch.cuda.is_available() is False" in r.stderr
    assert "dev agent: http" not in r.stdout


def test_agent_config_file_sets_the_defaults(tmp_path):
    cfg = parse_agent_config("""
region     = "east"
datacenter = "dc9"
ports { http = 0 }
server {
  workers = 3
  eval_batching = true
  batch_width = 8
  scheduler_algorithm = "tpu-binpack"
}
client { simulated_nodes = 1 }
telemetry {
  statsd_address = "127.0.0.1:9"
  interval = 2
}
""")
    assert (cfg.region, cfg.datacenter, cfg.http_port) == ("east", "dc9", 0)
    assert (cfg.server.workers, cfg.server.batch_width) == (3, 8)
    assert cfg.server.eval_batching and cfg.client.simulated_nodes == 1
    assert cfg.telemetry.statsd_address == "127.0.0.1:9"
    assert cfg.telemetry.interval_s == 2.0
    with pytest.raises(ValueError, match="cert_file and key_file"):
        parse_agent_config("tls { http = true }")
    with pytest.raises(HclError):
        parse_agent_config("server {")


def test_devagent_config_file_drives_the_agent(tmp_path):
    conf = tmp_path / "agent.hcl"
    conf.write_text("""
ports { http = 0 }
server {
  scheduler_algorithm = "tpu-binpack"
}
client { simulated_nodes = 1 }
telemetry { statsd_address = "127.0.0.1:9" }
""")
    agent = AgentProcess(["--device", "cpu", "--config", str(conf)],
                         tmp_path)
    try:
        addr = agent.address(120.0)
        api = ApiClient(addr)
        wait_until(lambda: len(api.nodes()) == 1, timeout=30.0,
                   msg="one simulated node")
        assert api.scheduler_config()["scheduler_algorithm"] == \
            "tpu-binpack"
    finally:
        rc = agent.stop()
    assert rc == 0


# -- fingerprints -------------------------------------------------------------

def _fake_cuda(monkeypatch, cards):
    props = [SimpleNamespace(name=name, total_memory=mem, uuid=uuid)
             for name, mem, uuid in cards]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: bool(cards))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: len(cards))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: props[i])


def test_fingerprint_reads_two_fake_cards(monkeypatch, tmp_path):
    _fake_cuda(monkeypatch, [
        ("NVIDIA H100 80GB HBM3", 85_000_000_000, "u-0"),
        ("NVIDIA H100 80GB HBM3", 85_000_000_000, None)])
    node = FingerprintManager(data_dir=str(tmp_path),
                              probe_cuda=True).fingerprint_node()
    assert node.attributes["gpu.count"] == "2"
    assert node.attributes["accelerator.NVIDIA H100 80GB HBM3.count"] == "2"
    (dev,) = node.node_resources.devices
    assert (dev.vendor, dev.type, dev.name) == (
        "nvidia", "gpu", "NVIDIA H100 80GB HBM3")
    assert dev.instance_ids == ["u-0", "1"]
    assert dev.attributes["memory_mib"] == 85_000_000_000 >> 20
    assert dev.matches_request("nvidia/gpu")
    assert dev.matches_request("nvidia/gpu/NVIDIA H100 80GB HBM3")
    assert "accelerator" in node.attributes["fingerprinters"]


def test_fingerprint_groups_card_models(monkeypatch, tmp_path):
    _fake_cuda(monkeypatch, [("A", 1 << 34, "a"), ("B", 1 << 35, "b"),
                             ("A", 1 << 34, "c")])
    node = FingerprintManager(data_dir=str(tmp_path),
                              probe_cuda=True).fingerprint_node()
    assert node.attributes["gpu.count"] == "3"
    assert {(d.name, tuple(d.instance_ids))
            for d in node.node_resources.devices} == {
        ("A", ("a", "c")), ("B", ("b",))}


def test_fingerprint_without_a_card(monkeypatch, tmp_path):
    _fake_cuda(monkeypatch, [])
    node = FingerprintManager(data_dir=str(tmp_path),
                              probe_cuda=True).fingerprint_node()
    assert node.attributes["gpu.count"] == "0"
    assert node.node_resources.devices == []


def test_fingerprint_probes_nothing_unless_asked(monkeypatch, tmp_path):
    def boom(*a):
        raise AssertionError("CUDA touched")
    monkeypatch.setattr(torch.cuda, "is_available", boom)
    node = FingerprintManager(data_dir=str(tmp_path)).fingerprint_node()
    assert "gpu.count" not in node.attributes
    assert node.node_resources.devices == []
    assert node.attributes["unique.storage.volume"] == str(tmp_path)
    assert int(node.attributes["cpu.numcores"]) >= 1
    assert node.node_resources.cpu.cpu_shares > 0


def test_fingerprint_matches_the_reference_without_accelerators(tmp_path):
    from nomad_tpu.client.fingerprint import FingerprintManager as RefFM
    got = FingerprintManager(data_dir=str(tmp_path)).fingerprint_node()
    want = RefFM(data_dir=str(tmp_path)).fingerprint_node()
    skip = {"unique.storage.bytesfree"}       # the disk moves meanwhile
    assert {k: v for k, v in got.attributes.items() if k not in skip} == \
        {k: v for k, v in want.attributes.items() if k not in skip}


def test_numa_scan_reads_sysfs_and_falls_back(tmp_path):
    from nomad_tpu.client import numalib as ref_numalib
    for n, cpus in ((0, "0-3,8"), (1, "4-7")):
        d = tmp_path / f"node{n}"
        d.mkdir()
        (d / "cpulist").write_text(cpus + "\n")
    topo = numalib.scan(str(tmp_path))
    assert topo.nodes == ref_numalib.scan(str(tmp_path)).nodes
    assert topo.core_count == 9 and topo.node_of(8) == 0
    empty = numalib.scan(str(tmp_path / "none"))
    assert empty.nodes == {0: list(range(os.cpu_count() or 1))}
    assert numalib.parse_cpulist("0-2, 5") == [0, 1, 2, 5]


def test_accelerator_module_touches_no_cuda_at_import():
    code = ("import torch\n"
            "torch.cuda.is_available = lambda: (_ for _ in ()).throw("
            "AssertionError('touched'))\n"
            "import nomad_tpu_torch.client.fingerprint, "
            "nomad_tpu_torch.api.http, nomad_tpu_torch.cli\n"
            "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "ok" in r.stdout, r.stderr
    assert fingerprint.AcceleratorFingerprinter().fingerprint(
        pst.Node()) == {}


# -- the profiler endpoint -----------------------------------------------------

def test_torch_profile_endpoint_on_the_cpu(monkeypatch, tmp_path):
    """start, a job through the API, stop: a chrome trace in the given
    directory; a second start and a stop without one answer 400."""
    with agents(monkeypatch) as (_, port):
        _, api = port
        out = tmp_path / "trace"
        assert api.post("/v1/agent/torch-profile",
                        {"action": "start", "dir": str(out)}) == {
            "tracing": True, "dir": str(out)}
        with pytest.raises(ApiError) as e:
            api.post("/v1/agent/torch-profile",
                     {"action": "start", "dir": str(out)})
        assert e.value.status == 400 and "already running" in str(e.value)
        pst.reseed_ids(90)
        eid = api.register_job(to_jsonable(
            pmock.job(id="prof-job")))["eval_id"]
        wait_until(lambda: settled(port[0], [eid]), msg="profiled job")
        reply = api.post("/v1/agent/torch-profile", {"action": "stop",
                                                     "dir": str(out)})
        assert reply["tracing"] is False
        trace = json.loads(open(reply["trace"]).read())
        assert reply["trace"].startswith(str(out))
        assert trace["traceEvents"]
        with pytest.raises(ApiError) as e:
            api.post("/v1/agent/torch-profile", {"action": "stop"})
        assert e.value.status == 400 and "not running" in str(e.value)
        with pytest.raises(ApiError) as e:
            api.post("/v1/agent/torch-profile", {"action": "go"})
        assert e.value.status == 400
