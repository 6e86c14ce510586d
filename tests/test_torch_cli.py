"""The port's operator CLI (nomad_tpu_torch/cli.py) held against the JAX
package's on the CPU: the same argv through both CLIs, each against its
own agent on one world (tests/test_torch_http.py ``agents``), stdout
compared after normalizing ids minted by worker threads. The cases are
the reference's tests/test_jobspec_cli.py::test_cli_end_to_end (but for
the commands over layers the port lacks: server members, var, operator
keyring) and tests/test_backend_guard.py::
test_cli_operator_solver_status_and_reprobe, then the rest of the port's
commands: job inspect / history / revert, node drain / eligibility /
purge, alloc stop, deployment, eval, system gc, metrics and the operator
reports (node flaps, workers, evals quarantine, the sanitizers,
transfers, trace, quality), and job plan (exit 1 when a group would
fail), job scale, job dispatch and operator snapshot save / restore;
with ACLs on, acl bootstrap / policy apply / token create / role,
namespace, node-pool, service and status <prefix>, as the management
token and as one that is refused.
Tolerance: exact, but for the lines the
port's own layers print differently (the resident set where the
reference prints its const cache; the jitcheck counters of a kernel
library instead of XLA's traces), which are checked for their keys,
and the stack arenas' counters, which count every generation the test
process ran before.
"""
import json
import re

import pytest
import torch

from nomad_tpu import cli as ref_cli
from nomad_tpu.solver import guard as ref_guard
from nomad_tpu.structs.job import reseed_ids as ref_reseed_ids

from nomad_tpu_torch import cli
from nomad_tpu_torch import structs as pst
from nomad_tpu_torch.solver import guard

from test_jobspec_cli import MINI_SPEC
from test_torch_http import N_NODES, agents, id_names, settled
from test_torch_server import fresh_state, wait_until  # noqa: F401
from test_torch_telemetry import reset_globals

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def fresh_telemetry():
    reset_globals()
    yield
    reset_globals()


def _norm_out(text, server):
    """Full ids and their 8-character prefixes (the tables' ID columns)
    of worker-minted ids become the names test_torch_http gives them,
    and wall times 0."""
    names = id_names(server)
    for full, name in sorted(names.items(), key=lambda kv: -len(kv[0])):
        text = text.replace(full, name)
    for full, name in names.items():
        text = re.sub(rf"\b{re.escape(full[:8])}\b", name, text)
    # wall times in the JSON outputs
    return re.sub(r'("[a-z_]*(?:time|_at)[a-z_]*": )[0-9.e+-]+', r"\g<1>0",
                  text)


def run_both(capsys, ref, port, argv, rc=0):
    """One argv through both CLIs; (port stdout, reference stdout),
    normalized."""
    outs = []
    for (server, api), main in ((ref, ref_cli.main), (port, cli.main)):
        got = main(["-address", api.address] + argv)
        out = capsys.readouterr().out
        assert got == rc, (argv, got, out)
        outs.append(_norm_out(out, server))
    # the port's knobs carry their own prefix
    return outs[1].replace("NOMAD_TPU_TORCH_", "NOMAD_TPU_"), outs[0]


def same_out(capsys, ref, port, argv, rc=0):
    got, want = run_both(capsys, ref, port, argv, rc)
    assert got == want, argv
    return got


def settle_all(*pairs):
    for server, _ in pairs:
        wait_until(lambda s=server: settled(
            s, [e.id for e in s.state.evals()]), msg="settled")


def reseed(seed):
    ref_reseed_ids(seed)
    pst.reseed_ids(seed)


def test_cli_end_to_end_equals_the_reference(monkeypatch, capsys,
                                             tmp_path):
    spec_file = tmp_path / "mini.hcl"
    spec_file.write_text(MINI_SPEC)
    with agents(monkeypatch) as (ref, port):
        reseed(101)
        got = same_out(capsys, ref, port, ["job", "run", str(spec_file)])
        assert "Evaluation" in got
        settle_all(ref, port)
        assert same_out(capsys, ref, port,
                        ["job", "status"]).count("mini") == 1
        assert "Allocations" in same_out(capsys, ref, port,
                                         ["job", "status", "mini"])
        assert same_out(capsys, ref, port,
                        ["node", "status"]).count("ready") >= 1
        same_out(capsys, ref, port, ["eval"])
        got = same_out(capsys, ref, port, ["operator", "scheduler",
                                           "-scheduler-algorithm", "spread"])
        assert "spread" in got
        assert port[0].state.scheduler_config().scheduler_algorithm == \
            "spread"
        alloc_id = port[1].job_allocations("mini")[0]["id"]
        ref_alloc = next(a.id for a in ref[0].state.allocs()
                         if a.name == port[0].state.alloc_by_id(
                             alloc_id).name)
        outs = []
        for (server, api), main, aid in ((ref, ref_cli.main, ref_alloc),
                                         (port, cli.main, alloc_id)):
            assert main(["-address", api.address, "alloc", "status",
                         aid]) == 0
            out = capsys.readouterr().out
            assert aid in out
            outs.append(_norm_out(out, server))
        assert outs[0] == outs[1]
        reseed(102)
        same_out(capsys, ref, port, ["job", "stop", "mini"])
        settle_all(ref, port)
        same_out(capsys, ref, port, ["job", "status", "mini"])
        got = same_out(capsys, ref, port, ["system", "gc"])
        assert json.loads(got)
        assert "nomad-tpu" in same_out(capsys, ref, port, ["version"])


def _solver_lines(text, resident_as):
    """key -> value of `operator solver status`; the port's resident set
    lines named as the reference's const cache lines."""
    out = {}
    for line in text.splitlines():
        key, _, val = line.partition("=")
        key = key.strip().replace("resident.", resident_as)
        out[key] = val.strip()
    return out


def test_cli_operator_solver_status_and_reprobe(monkeypatch, capsys):
    """The reference's drill through both CLIs: a guard whose init timed
    out reads degraded, and a reprobe whose transport probe sees a card
    says the process is wedged."""
    for g in (guard, ref_guard):
        g._reset_for_tests()
        g._STATE.update(checked=True, ok=False, probe_timed_out=True)
        monkeypatch.setattr(g, "_subprocess_probe", lambda timeout: {
            "timed_out": False, "rc": 0, "devices": 1})
    monkeypatch.setattr(guard, "_FLAGS", (True, False))
    monkeypatch.setattr(ref_guard, "_FLAGS", (True, False))
    with agents(monkeypatch) as (ref, port):
        got, want = run_both(capsys, ref, port,
                             ["operator", "solver", "status"])
        assert "ok" in got and "= False" in got
        g = _solver_lines(got, "const_cache.")
        w = _solver_lines(want, "const_cache.")
        assert set(g) == set(w) - {"dispatch.bytes_total"}
        differ = {k for k in g if g[k] != w[k]}
        # the resident set is the port's own (its cache entries); the
        # pack's time is a wall time; the stack arenas' counters are the
        # process's (they count every earlier test's generations too)
        assert differ <= {"pack.p50_ms"} | {
            k for k in g if k.startswith("const_cache.")
            or (k.startswith("pack_arena.") and k != "pack_arena.enabled")
        }, differ
        got, want = run_both(capsys, ref, port,
                             ["operator", "solver", "reprobe"])
        assert got == want
        assert "recovered" in got and "restart the agent" in got


def test_the_rest_of_the_commands(monkeypatch, capsys):
    with agents(monkeypatch) as (ref, port):
        node_id = port[0].state.nodes()[0].id
        for server, api in (ref, port):
            reseed(111)
            api.register_job_hcl(MINI_SPEC)
        settle_all(ref, port)
        assert '"id": "mini"' in same_out(capsys, ref, port,
                                           ["job", "inspect", "mini"])
        same_out(capsys, ref, port, ["job", "history", "mini"])
        reseed(112)
        # the current version: refused alike
        same_out(capsys, ref, port, ["job", "revert", "mini", "0"], rc=1)
        for server, api in (ref, port):
            reseed(117)
            api.register_job_hcl(MINI_SPEC.replace("count = 2",
                                                   "count = 3"))
        settle_all(ref, port)
        reseed(118)
        same_out(capsys, ref, port, ["job", "revert", "mini", "0"])
        settle_all(ref, port)
        same_out(capsys, ref, port, ["job", "history", "mini"])
        eid = port[1].job_evaluations("mini")[0]["id"]
        same_out(capsys, ref, port, ["eval", eid])
        same_out(capsys, ref, port, ["deployment"])
        same_out(capsys, ref, port, ["deployment", "list"])
        reseed(113)
        same_out(capsys, ref, port, ["node", "eligibility", node_id,
                                     "-disable"])
        same_out(capsys, ref, port, ["node", "eligibility", node_id,
                                     "-enable"])
        same_out(capsys, ref, port, ["node", "status", node_id])
        same_out(capsys, ref, port, ["node", "drain", node_id, "-enable",
                                     "-deadline", "60"])
        settle_all(ref, port)
        same_out(capsys, ref, port, ["node", "drain", node_id, "-disable"])
        alloc = next(a for a in port[0].state.allocs()
                     if not a.terminal_status())
        ref_alloc = next(a for a in ref[0].state.allocs()
                         if a.name == alloc.name
                         and not a.terminal_status())
        for (server, api), main, aid in ((ref, ref_cli.main, ref_alloc.id),
                                         (port, cli.main, alloc.id)):
            reseed(114)
            assert main(["-address", api.address, "alloc", "stop",
                         aid]) == 0
            assert "follow-up eval" in capsys.readouterr().out
        settle_all(ref, port)
        reseed(115)
        same_out(capsys, ref, port, ["node", "purge", node_id])
        settle_all(ref, port)
        same_out(capsys, ref, port, ["node", "status"])
        same_out(capsys, ref, port, ["job", "status", "mini"])
        same_out(capsys, ref, port, ["operator", "node", "flaps"])
        same_out(capsys, ref, port, ["operator", "evals", "quarantine"])
        same_out(capsys, ref, port, ["operator", "evals", "quarantine",
                                     "--release-all"])
        for argv in (["operator", "lockcheck"], ["operator", "statecheck"],
                     ["operator", "schedcheck"]):
            same_out(capsys, ref, port, argv)
        got, _ = run_both(capsys, ref, port, ["operator", "workers"])
        assert "restarts_total" in got
        got, _ = run_both(capsys, ref, port, ["operator", "sanitizers"])
        assert [ln.split()[0] for ln in got.splitlines()[1:5]] == [
            "lockcheck", "jitcheck", "statecheck", "schedcheck"]
        assert cli.main(["-address", port[1].address, "operator",
                         "jitcheck", "--sites"]) == 0
        out = capsys.readouterr().out
        assert "rebuild_count" in out and "host_sync_count" in out
        for argv in (["operator", "transfers"], ["operator", "quality"],
                     ["operator", "trace"], ["operator", "trace",
                                             "--slowest", "2"],
                     ["metrics"]):
            assert cli.main(["-address", port[1].address] + argv) == 0, argv
            assert capsys.readouterr().out
        assert cli.main(["-address", port[1].address, "operator", "trace",
                         "no-such-eval"]) == 1
        assert "No trace" in capsys.readouterr().err
        reseed(116)
        same_out(capsys, ref, port, ["job", "stop", "-purge", "mini"])
        settle_all(ref, port)
        same_out(capsys, ref, port, ["job", "status"])


def test_schedcheck_replay_runs_the_ports_scenario(capsys):
    assert cli.main(["operator", "schedcheck", "--replay", "11",
                     "--scenario", "broker-smoke"]) == 0
    out = capsys.readouterr().out
    assert "seed         = 11" in out and "violations   = 0" in out
    assert cli.main(["operator", "schedcheck", "--replay", "1",
                     "--scenario", "nope"]) == 2


def test_unported_commands_are_not_registered(capsys):
    for argv in (["var", "list"], ["volume", "status"],
                 ["plugin", "status"], ["server", "members"],
                 ["monitor"], ["operator", "keyring", "list"]):
        with pytest.raises(SystemExit) as e:
            cli.main(argv)
        assert e.value.code == 2, argv
        capsys.readouterr()


def test_agent_command_runs_the_dev_agent(monkeypatch):
    """`agent` hands its flags to the dev agent, --device included."""
    seen = {}
    from nomad_tpu_torch.api import devagent
    monkeypatch.setattr(devagent, "main",
                        lambda argv: seen.setdefault("argv", argv) and 0)
    cli.main(["agent", "--nodes", "2", "--port", "0", "--tpu", "--device",
              "cpu"])
    assert seen["argv"] == ["--nodes", "2", "--port", "0", "--workers", "2",
                            "--tpu", "--device", "cpu"]


SCALY_SPEC = """
job "scaly" {
  group "web" {
    count = 2
    scaling {
      min = 1
      max = 5
    }
    task "t" {
      driver = "mock"
      resources { cpu = 100 memory = 64 }
    }
  }
}
"""
PARAM_SPEC = """
job "batcher" {
  type = "batch"
  parameterized {
    meta_required = ["k"]
  }
  group "g" {
    count = 2
    task "t" {
      driver = "mock"
      resources { cpu = 100 memory = 64 }
    }
  }
}
"""


def test_job_plan_scale_dispatch_and_snapshot_commands(monkeypatch, capsys,
                                                       tmp_path):
    """job plan (exit 1 when a group would fail), job scale, job
    dispatch and operator snapshot save / restore through both CLIs."""
    from nomad_tpu.server import core as ref_core
    from nomad_tpu_torch.server import core as port_core
    from test_torch_http import _PinnedTime
    clock = _PinnedTime(1_700_000_000.0)
    monkeypatch.setattr(ref_core, "time", clock)
    monkeypatch.setattr(port_core, "time", clock)
    files = {}
    for name, src in (("mini", MINI_SPEC), ("scaly", SCALY_SPEC),
                      ("batcher", PARAM_SPEC),
                      ("big", MINI_SPEC.replace("cpu    = 100",
                                                "cpu    = 90000"))):
        files[name] = tmp_path / f"{name}.hcl"
        files[name].write_text(src)
    noid = tmp_path / "noid.json"
    noid.write_text(json.dumps({"job": {"type": "service"}}))
    with agents(monkeypatch) as (ref, port):
        reseed(301)
        got = same_out(capsys, ref, port, ["job", "plan",
                                           str(files["mini"])])
        assert "(Added)" in got and "placed: 2" in got
        assert port[0].state.job_by_id("default", "mini") is None
        # a group no node holds: exit 1 in both; the port names the
        # exhausted dimension
        reseed(302)
        got, want = run_both(capsys, ref, port,
                             ["job", "plan", str(files["big"])], rc=1)
        assert "WARNING: group 'g' would fail placement" in want
        assert f"{N_NODES} nodes evaluated" in got
        assert "exhausted: {'cpu': %d}" % N_NODES in got
        same_out(capsys, ref, port, ["job", "plan", str(noid)], rc=1)
        # scale within and outside the bounds
        reseed(303)
        same_out(capsys, ref, port, ["job", "run", str(files["scaly"])])
        settle_all(ref, port)
        reseed(304)
        same_out(capsys, ref, port, ["job", "scale", "scaly", "web", "4",
                                     "-message", "more"])
        settle_all(ref, port)
        same_out(capsys, ref, port, ["job", "scale", "scaly", "web", "9"],
                 rc=1)
        assert len(port[1].job_allocations("scaly")) == 4
        # dispatch
        reseed(305)
        same_out(capsys, ref, port, ["job", "run", str(files["batcher"])])
        reseed(306)
        got = same_out(capsys, ref, port, ["job", "dispatch", "batcher",
                                           "-meta", "k=v"])
        assert "batcher/dispatch-1700000000-" in got
        same_out(capsys, ref, port, ["job", "dispatch", "batcher"], rc=1)
        settle_all(ref, port)
        same_out(capsys, ref, port, ["job", "status"])
        # operator snapshot save, a job purged, restore
        outs = []
        for name, ((server, api), main) in (("ref", (ref, ref_cli.main)),
                                            ("port", (port, cli.main))):
            path = tmp_path / f"{name}.snap"
            assert main(["-address", api.address, "operator", "snapshot",
                         "save", str(path)]) == 0
            out = capsys.readouterr().out
            assert out.startswith(f"Snapshot written to {path} (")
            server.state.delete_job("default", "scaly")
            assert main(["-address", api.address, "operator", "snapshot",
                         "restore", str(path)]) == 0
            outs.append(capsys.readouterr().out)
            assert server.state.job_by_id("default", "scaly") is not None
        assert outs[0] == outs[1] and outs[1].startswith(
            "Snapshot restored (index ")
        same_out(capsys, ref, port, ["job", "status", "scaly"])


def _no_uuids(text):
    return re.sub(r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-"
                  r"[0-9a-f]{12}", "<uuid>", text)


def test_acl_bootstrap_through_both_clis(monkeypatch, capsys):
    """`acl bootstrap` on agents with ACLs on: the token printed (its
    random ids aside), then refused, alike."""
    with agents(monkeypatch, acl=True) as (ref, port):
        got, want = run_both(capsys, ref, port, ["acl", "bootstrap"])
        assert _no_uuids(got) == _no_uuids(want)
        assert "Type        = management" in got
        for (server, api), main in ((ref, ref_cli.main), (port, cli.main)):
            assert main(["-address", api.address, "acl", "bootstrap"]) == 1
            assert "already bootstrapped" in capsys.readouterr().err


def test_cluster_table_and_acl_commands_equal_the_reference(
        monkeypatch, capsys, tmp_path):
    """The new commands through both CLIs on agents with ACLs on, as the
    management token ($NOMAD_TOKEN, as the reference's CLI reads it):
    acl policy apply / token create / role, namespace, node-pool,
    service and status <prefix>; then as a token that may not, refused
    alike; the port's -token flag wins over $NOMAD_TOKEN."""
    from test_torch_http import acl_world, service_regs
    store, secrets, _ = acl_world()
    pol = tmp_path / "team.hcl"
    pol.write_text('namespace "team-a" { policy = "read" }\n')
    spec_file = tmp_path / "mini.hcl"
    spec_file.write_text(MINI_SPEC)
    with agents(monkeypatch, store=store, acl=True) as (ref, port):
        monkeypatch.setenv("NOMAD_TOKEN", secrets["management"])
        for (server, api) in (ref, port):
            api.token = secrets["management"]
            api.post("/v1/node/services-register",
                     {"services": service_regs()})
        reseed(131)
        same_out(capsys, ref, port, ["job", "run", str(spec_file)])
        settle_all(ref, port)
        for argv, rc in (
                (["acl", "policy", "apply", "team", str(pol),
                  "-description", "t"], 0),
                (["acl", "role", "apply", "ops", "-policy", "team",
                  "-policy", "ro"], 0),
                (["acl", "role", "apply", "bad", "-policy", "nope"], 1),
                (["acl", "role", "list"], 0),
                (["acl", "role", "delete", "ops"], 0),
                (["namespace", "apply", "team-c", "-description", "c"], 0),
                (["namespace", "list"], 0),
                (["namespace", "delete", "team-c"], 0),
                (["namespace", "delete", "default"], 1),
                (["node-pool", "apply", "pool-c", "-description", "c",
                  "-scheduler-algorithm", "spread"], 0),
                (["node-pool", "list"], 0),
                (["node-pool", "nodes", "default"], 0),
                (["node-pool", "delete", "pool-c"], 0),
                (["node-pool", "delete", "default"], 1),
                (["service", "list"], 0),
                (["service", "info", "web-svc"], 0),
                (["-namespace", "team-a", "service", "info", "web-svc"], 0),
                (["status", "mini"], 0),
                (["status", "zz"], 1),
                (["-namespace", "*", "status", ""], 0)):
            got = same_out(capsys, ref, port, argv, rc=rc)
            if rc == 0:
                assert got.strip(), argv
        got, want = run_both(capsys, ref, port, [
            "acl", "token", "create", "-name", "t", "-policy", "team"])
        assert _no_uuids(got) == _no_uuids(want)
        assert "Policies    = ['team']" in got
        # a read-only token: refused alike
        monkeypatch.setenv("NOMAD_TOKEN", secrets["read"])
        for argv in (["namespace", "apply", "x"], ["acl", "role", "list"],
                     ["node-pool", "apply", "x"]):
            same_out(capsys, ref, port, argv, rc=1)
        same_out(capsys, ref, port, ["namespace", "list"])
        same_out(capsys, ref, port, ["-namespace", "*", "status", ""])
        # -token wins over $NOMAD_TOKEN (the port's flag)
        assert cli.main(["-address", port[1].address, "-token",
                         secrets["management"], "namespace", "apply",
                         "x"]) == 0
        assert "Namespace 'x' applied" in capsys.readouterr().out
        monkeypatch.delenv("NOMAD_TOKEN")
        assert cli.main(["-address", port[1].address, "namespace",
                         "apply", "y"]) == 1
        assert "Permission denied" in capsys.readouterr().err
