"""HTTP API: the /v1/* routes the port's Server backs (port of
nomad_tpu/api/http.py; upstream: command/agent/http.go:382
registerHandlers and the per-resource endpoint files). JSON in and out;
blocking queries take ?index=N&wait=Ns, as upstream's blocking-query
contract (nomad/rpc.go:852).

Routes:
  GET    /v1/jobs[?prefix=]                    POST /v1/jobs, /v1/jobs/parse
  GET    /v1/job/<id>[/allocations|evaluations|summary|versions|deployment
                          |scale]
  POST   /v1/job/<id>/revert|stable|periodic/force|plan|dispatch|scale
  GET    /v1/scaling/policies[?job=], /v1/scaling/policy/<id>
  DELETE /v1/job/<id>[?purge=true]
  GET    /v1/evaluations[?prefix=], /v1/evaluation/<id>[/allocations]
  GET    /v1/allocations[?prefix=], /v1/allocation/<id>
  POST   /v1/allocation/<id>/stop
  GET    /v1/nodes, /v1/node/<id>, /v1/node/<id>/allocations (blocking)
  POST   /v1/node/register, /v1/node/allocs-update,
         /v1/node/services-register,
         /v1/node/<id>/heartbeat|drain|eligibility|purge
  GET    /v1/node/pools, /v1/node/pool/<name>[/nodes]
  POST   /v1/node/pools, /v1/node/pool/<name>   DELETE /v1/node/pool/<name>
  GET    /v1/namespaces, /v1/namespace/<name>
  POST   /v1/namespace[/<name>]                 DELETE /v1/namespace/<name>
  GET    /v1/services, /v1/service/<name>       DELETE /v1/service/<name>/<id>
  POST   /v1/search, /v1/search/fuzzy
  GET    /v1/acl/policies|roles|tokens, /v1/acl/policy|role|token/<x>,
         /v1/acl/token/self
  POST   /v1/acl/bootstrap, /v1/acl/policy/<name>, /v1/acl/role/<name>,
         /v1/acl/token             DELETE /v1/acl/policy|role|token/<x>
  GET    /v1/deployments             POST /v1/deployment/pause|fail|promote/<id>
  GET    /v1/event/stream[?poll=true]      POST /v1/system/gc
  GET    /v1/operator/scheduler/configuration (and POST)
  POST   /v1/operator/solver/reprobe, /v1/operator/quarantine
  GET    /v1/operator/snapshot (the archive, application/octet-stream);
         PUT or POST /v1/operator/snapshot restores one
  GET    /v1/operator/faults (and POST), /v1/operator/quality
  GET    /v1/agent/self, /v1/agent/health, /v1/agent/trace[/<eval id>]
  POST   /v1/agent/torch-profile
  GET    /v1/metrics[?format=prometheus], /v1/status/leader

Any other path answers 404. A request's token is its X-Nomad-Token
header (or ?token=). With the Server's ACLs on, every route checks the
capabilities the reference's checks, in the same place: before any
blocking wait and any write, in the query's namespace (any namespace
for ``namespace=*``) and, for a single namespaced object, again in the
object's namespace once it is read; list routes drop the rows of
namespaces the token may not read, and a refusal answers 403
"Permission denied". With ACLs off every request holds the management
ACL. The port's Server has no CSI, variables, keyring, federation or
raft, so their routes are not here; the web UI, the agent monitor and
the client fs/exec/logs routes are not either.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from ..acl import (
    CAP_ALLOC_LIFECYCLE, CAP_DISPATCH_JOB, CAP_LIST_JOBS,
    CAP_LIST_SCALING_POLICIES, CAP_PARSE_JOB, CAP_READ_JOB,
    CAP_READ_SCALING_POLICY, CAP_SCALE_JOB, CAP_SUBMIT_JOB,
)
from ..structs import (
    Affinity, Constraint, EphemeralDisk, Job, NetworkResource,
    ParameterizedJobConfig, PeriodicConfig, Port, ReschedulePolicy,
    Resources, RestartPolicy, SchedulerConfiguration, Service, Spread,
    SpreadTarget, Task, TaskGroup, UpdateStrategy,
)

TORCH_TRACE_DIR = "/tmp/torch-trace"


_PLAIN = frozenset((str, int, float, bool, type(None)))
# type -> its dataclass field names, or None for a type that is not one
_FIELDS: dict = {}


def _field_names(cls):
    try:
        return _FIELDS[cls]
    except KeyError:
        names = (tuple(f.name for f in dataclasses.fields(cls))
                 if dataclasses.is_dataclass(cls) else None)
        _FIELDS[cls] = names
        return names


def to_jsonable(obj, _seen=None):
    """JSON-able primitives of a struct, the reference's form (dataclass
    fields by name, recursively). A struct reached twice in one call (the
    Job every alloc of a job references) is converted once and its dict
    shared: the JSON text is the same. Scalars are taken as they are
    without a call: a reply of thousands of allocs is mostly scalars."""
    t = type(obj)
    if t in _PLAIN:
        return obj
    names = _field_names(t)
    if names is not None:
        if _seen is None:
            _seen = {}
        out = _seen.get(id(obj))
        if out is None:
            out = {}
            for name in names:
                v = getattr(obj, name)
                out[name] = v if type(v) in _PLAIN else to_jsonable(v, _seen)
            _seen[id(obj)] = out
        return out
    hydrate = getattr(t, "__nomad_hydrate__", None)
    if hydrate is not None:
        # a lazy struct (structs.alloc.LazyAllocMetric): an API read is a
        # first access, so the hydrated record is rendered (reference :74)
        return to_jsonable(hydrate(obj), _seen)
    if isinstance(obj, dict):
        return {str(k): v if type(v) in _PLAIN else to_jsonable(v, _seen)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set, frozenset)):
        return [v if type(v) in _PLAIN else to_jsonable(v, _seen)
                for v in obj]
    if isinstance(obj, bytes):
        return obj.decode("utf-8", "replace")
    return obj


def job_from_json(data: dict) -> Job:
    """A Job from the JSON jobspec (upstream's api.Job JSON shape, snake
    cased), field for field as the reference builds it: task devices
    and group volumes are not read from JSON (HCL carries them)."""
    def build(cls, src, **overrides):
        fields = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in (src or {}).items() if k in fields}
        kwargs.update(overrides)
        return cls(**kwargs)

    def networks_of(src):
        return [build(NetworkResource, n,
                      reserved_ports=[build(Port, p) for p in
                                      n.get("reserved_ports", [])],
                      dynamic_ports=[build(Port, p) for p in
                                     n.get("dynamic_ports", [])])
                for n in src.get("networks", [])]

    tgs = []
    for tg_src in data.get("task_groups", []):
        tasks = []
        for t_src in tg_src.get("tasks", []):
            res_src = t_src.get("resources", {})
            resources = build(Resources, res_src,
                              networks=networks_of(res_src), devices=[])
            tasks.append(build(
                Task, t_src, resources=resources,
                constraints=[build(Constraint, c)
                             for c in t_src.get("constraints", [])],
                affinities=[build(Affinity, a)
                            for a in t_src.get("affinities", [])],
                services=[build(Service, s)
                          for s in t_src.get("services", [])]))
        tg = build(
            TaskGroup, tg_src, tasks=tasks, networks=networks_of(tg_src),
            services=[build(Service, s)
                      for s in tg_src.get("services", [])],
            constraints=[build(Constraint, c)
                         for c in tg_src.get("constraints", [])],
            affinities=[build(Affinity, a)
                        for a in tg_src.get("affinities", [])],
            spreads=[build(Spread, s,
                           spread_target=[build(SpreadTarget, t)
                                          for t in s.get("spread_target", [])])
                     for s in tg_src.get("spreads", [])],
            update=(build(UpdateStrategy, tg_src["update"])
                    if tg_src.get("update") else None),
            restart_policy=build(RestartPolicy,
                                 tg_src.get("restart_policy", {})),
            reschedule_policy=(build(ReschedulePolicy,
                                     tg_src["reschedule_policy"])
                               if tg_src.get("reschedule_policy") else None),
            ephemeral_disk=build(EphemeralDisk,
                                 tg_src.get("ephemeral_disk", {})),
            volumes={}, scaling=tg_src.get("scaling"), migrate=None)
        tgs.append(tg)
    job = Job(
        id=data.get("id", ""),
        name=data.get("name", data.get("id", "")),
        namespace=data.get("namespace", "default"),
        type=data.get("type", "service"),
        priority=int(data.get("priority", 50)),
        all_at_once=bool(data.get("all_at_once", False)),
        datacenters=data.get("datacenters", ["*"]),
        node_pool=data.get("node_pool", "default"),
        constraints=[Constraint(**{k: v for k, v in c.items()
                                   if k in ("l_target", "r_target", "operand")})
                     for c in data.get("constraints", [])],
        affinities=[Affinity(**{k: v for k, v in a.items()
                                if k in ("l_target", "r_target", "operand",
                                         "weight")})
                    for a in data.get("affinities", [])],
        spreads=[],
        task_groups=tgs,
        meta=data.get("meta", {}),
    )
    for key, cls in (("update", UpdateStrategy),
                     ("periodic", PeriodicConfig),
                     ("parameterized", ParameterizedJobConfig)):
        if data.get(key):
            setattr(job, key, build(cls, data[key]))
    return job


# bounds on the profiler session's start (CUPTI's first start can take
# tens of seconds) and on its stop and trace export
PROFILE_START_TIMEOUT_S = 120.0
PROFILE_STOP_TIMEOUT_S = 300.0


class TorchProfile:
    """The agent's torch.profiler session for /v1/agent/torch-profile
    (reference :1301, the JAX profiler's counterpart): ``start`` opens a
    profile of the CPU and, on a card agent, of CUDA (CUPTI records every
    kernel on the card, whichever thread launched it); ``stop`` ends it
    and writes its chrome trace into the directory. A second ``start``
    and a ``stop`` without one raise RuntimeError. The session lives on
    a thread of its own: the profiler must be started and stopped on one
    thread, and each request runs on a fresh one."""

    def __init__(self):
        self._lock = threading.Lock()
        self._session = None

    def start(self, trace_dir: str, cuda: bool) -> None:
        with self._lock:
            if self._session is not None:
                raise RuntimeError("torch profiler already running "
                                   f"(into {self._session['dir']})")
            sess = {"dir": trace_dir, "started": threading.Event(),
                    "stop": threading.Event(), "done": threading.Event(),
                    "error": None, "path": None}
            t = threading.Thread(target=self._run, args=(sess, cuda),
                                 daemon=True, name="torch-profile")
            t.start()
            if not sess["started"].wait(PROFILE_START_TIMEOUT_S):
                # a late start stops at once
                sess["stop"].set()
                raise RuntimeError(
                    "torch profiler: the session thread did not start "
                    f"the profiler within {PROFILE_START_TIMEOUT_S:.0f} s")
            if sess["error"] is not None:
                raise RuntimeError(f"torch profiler: {sess['error']}")
            self._session = sess

    def stop(self) -> str:
        with self._lock:
            sess = self._session
            if sess is None:
                raise RuntimeError("torch profiler not running")
            self._session = None
        sess["stop"].set()
        if not sess["done"].wait(PROFILE_STOP_TIMEOUT_S):
            raise RuntimeError(
                "torch profiler: the session thread did not stop the "
                f"profiler and write its trace within "
                f"{PROFILE_STOP_TIMEOUT_S:.0f} s")
        if sess["error"] is not None:
            raise RuntimeError(f"torch profiler: {sess['error']}")
        return sess["path"]

    @staticmethod
    def _run(sess: dict, cuda: bool) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if cuda:
            acts.append(ProfilerActivity.CUDA)
        try:
            prof = profile(activities=acts)
            prof.start()
        except Exception as e:  # noqa: BLE001 -- reported to the caller
            sess["error"] = f"{type(e).__name__}: {e}"
            sess["started"].set()
            return
        sess["started"].set()
        sess["stop"].wait()
        try:
            prof.stop()
            os.makedirs(sess["dir"], exist_ok=True)
            path = os.path.join(sess["dir"],
                                f"torch-trace-{time.time_ns()}.json")
            prof.export_chrome_trace(path)
            sess["path"] = path
        except Exception as e:  # noqa: BLE001 -- reported to the caller
            sess["error"] = f"{type(e).__name__}: {e}"
        finally:
            sess["done"].set()


class ApiHandler(BaseHTTPRequestHandler):
    server_version = "nomad-tpu-torch/0.1"
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):
        pass

    @property
    def nomad(self):
        return self.server.nomad_server

    def handle(self):
        # one name for every request thread, so thread dumps and the
        # tracer's spans show the API's work as such (and a seeded id
        # stream gives a request the ids of its place in the request
        # order: structs/job.py _thread_rng)
        threading.current_thread().name = "http-request"
        super().handle()

    # ------------------------------------------------------------------
    def _send(self, code: int, payload, index: Optional[int] = None) -> None:
        body = json.dumps(to_jsonable(payload)).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if index is not None:
            self.send_header("X-Nomad-Index", str(index))
        self.end_headers()
        self.wfile.write(body)

    def _error(self, code: int, msg: str) -> None:
        self._send(code, {"error": msg})

    def _send_bytes(self, data: bytes) -> None:
        self.send_response(200)
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _raw_body(self) -> bytes:
        length = int(self.headers.get("Content-Length", 0) or 0)
        return self.rfile.read(length) if length else b""

    def _body(self):
        length = int(self.headers.get("Content-Length", 0) or 0)
        if not length:
            return {}
        return json.loads(self.rfile.read(length) or b"{}")

    def _blocking(self, query, tables=()) -> int:
        """?index / ?wait blocking semantics; returns the current index."""
        q = parse_qs(query)
        if "index" in q:
            min_index = int(q["index"][0])
            wait = 5.0
            if "wait" in q:
                wait = float(q["wait"][0].rstrip("s"))
            # capped as upstream's MaxBlockingRPCQueryTime, so a client
            # cannot pin a handler thread for long
            wait = min(wait, 300.0)
            return self.nomad.state.block_until(min_index, timeout=wait,
                                                tables=tables)
        return self.nomad.state.latest_index()

    # ------------------------------------------------------------------
    def do_GET(self):  # noqa: N802
        url = urlparse(self.path)
        parts = [p for p in url.path.split("/") if p]
        state = self.nomad.state
        try:
            # the node alloc watch blocks on the allocs table only, so
            # unrelated writes do not wake every polling node
            tables = (("allocs",) if parts[:2] == ["v1", "node"]
                      and len(parts) == 4 and parts[3] == "allocations"
                      else ())
            q = parse_qs(url.query)
            ns = q.get("namespace", ["default"])[0]
            acl = self._acl()
            # every check that can refuse runs before the blocking wait,
            # so a refused request cannot hold a thread for ?wait; a
            # single namespaced object is checked again in ITS namespace
            # once read (reference :398-467)
            if parts[:2] == ["v1", "acl"]:
                # management only, but a token's own record
                if parts != ["v1", "acl", "token", "self"] and \
                        not self._check(acl.is_management()):
                    return
                index = self._blocking(url.query, tables)
                return self._acl_get(parts, acl, index)
            if parts[1:2] == ["operator"]:
                if not self._check(acl.allow_operator_read()):
                    return
            elif parts[:2] in (["v1", "nodes"], ["v1", "node"]):
                if not self._check(acl.allow_node_read()):
                    return
            elif parts[:2] == ["v1", "job"]:
                if not self._check(acl.allow_namespace_op(ns, CAP_READ_JOB)):
                    return
            elif parts[:2] in (["v1", "jobs"], ["v1", "evaluations"],
                               ["v1", "allocations"], ["v1", "deployments"]):
                # a list: refused without access to the asked namespace
                # (any namespace for "*"), its rows filtered below
                cap = CAP_LIST_JOBS if parts[1] == "jobs" else CAP_READ_JOB
                if not self._check(self._ns_allowed(acl, ns, cap)):
                    return
            elif parts[:2] in (["v1", "evaluation"], ["v1", "allocation"]):
                if not self._check(acl.allow_any_namespace(CAP_READ_JOB)):
                    return
            elif parts[:2] in (["v1", "services"], ["v1", "service"]):
                if not self._check(self._ns_allowed(acl, ns, CAP_READ_JOB)):
                    return
            elif parts[:2] == ["v1", "scaling"]:
                if not self._check(self._ns_allowed(
                        acl, ns, CAP_LIST_SCALING_POLICIES)):
                    return
            elif parts == ["v1", "event", "stream"]:
                if not self._check(acl.allow_any_namespace(CAP_READ_JOB)):
                    return
                if q.get("poll", ["false"])[0] != "true":
                    # a live stream: ?index is the replay point, not a
                    # blocking-query parameter
                    return self._stream_events(
                        q, int(q.get("index", ["0"])[0]))
            elif parts[:2] == ["v1", "agent"] and parts[2:3] != ["health"]:
                if not self._check(acl.allow_agent_read()):
                    return
            elif parts == ["v1", "metrics"]:
                if not self._check(acl.allow_agent_read()):
                    return
            index = self._blocking(url.query, tables)
            if parts == ["v1", "jobs"]:
                prefix = q.get("prefix", [""])[0]
                self._send(200, [self._job_stub(j) for j in self._visible(
                    acl, state.jobs(), CAP_LIST_JOBS)
                    if j.id.startswith(prefix)], index)
            elif parts[:2] == ["v1", "job"] and len(parts) == 3:
                job = state.job_by_id(ns, parts[2])
                if job is None:
                    return self._error(404, "job not found")
                self._send(200, job, index)
            elif parts[:2] == ["v1", "job"] and len(parts) == 4:
                self._get_job_sub(ns, parts[2], parts[3], url.path, index)
            elif parts == ["v1", "evaluations"]:
                prefix = q.get("prefix", [""])[0]
                self._send(200, [e for e in self._visible(
                    acl, state.evals(), CAP_READ_JOB)
                    if e.id.startswith(prefix)], index)
            elif parts[:2] == ["v1", "evaluation"] and len(parts) == 3:
                ev = state.eval_by_id(parts[2])
                if ev is None:
                    return self._error(404, "eval not found")
                if not self._check(acl.allow_namespace_op(ev.namespace,
                                                          CAP_READ_JOB)):
                    return
                self._send(200, ev, index)
            elif parts[:2] == ["v1", "evaluation"] and len(parts) == 4 \
                    and parts[3] == "allocations":
                ev = state.eval_by_id(parts[2])
                if ev is None:
                    return self._error(404, "eval not found")
                if not self._check(acl.allow_namespace_op(ev.namespace,
                                                          CAP_READ_JOB)):
                    return
                self._send(200, [a for a in state.allocs()
                                 if a.eval_id == parts[2]], index)
            elif parts == ["v1", "allocations"]:
                prefix = q.get("prefix", [""])[0]
                self._send(200, [a for a in self._visible(
                    acl, state.allocs(), CAP_READ_JOB)
                    if a.id.startswith(prefix)], index)
            elif parts[:2] == ["v1", "allocation"] and len(parts) == 3:
                a = state.alloc_by_id(parts[2])
                if a is None:
                    return self._error(404, "alloc not found")
                if not self._check(acl.allow_namespace_op(a.namespace,
                                                          CAP_READ_JOB)):
                    return
                self._send(200, a, index)
            elif parts == ["v1", "nodes"]:
                self._send(200, [self._node_stub(n) for n in state.nodes()],
                           index)
            elif parts[:2] == ["v1", "node"] and len(parts) == 3 and \
                    parts[2] not in ("pools", "pool"):
                n = state.node_by_id(parts[2])
                if n is None:
                    return self._error(404, "node not found")
                self._send(200, n, index)
            elif parts == ["v1", "node", "pools"]:
                self._send(200, state.node_pools(), index)
            elif parts[:3] == ["v1", "node", "pool"] and len(parts) == 4:
                p = state.node_pool_by_name(parts[3])
                if p is None:
                    return self._error(404, "node pool not found")
                self._send(200, p, index)
            elif parts[:3] == ["v1", "node", "pool"] and len(parts) == 5 \
                    and parts[4] == "nodes":
                self._send(200, [self._node_stub(n) for n in state.nodes()
                                 if n.node_pool == parts[3]], index)
            elif parts[:2] == ["v1", "node"] and len(parts) == 4 and \
                    parts[3] == "allocations":
                from ..structs import codec
                allocs = state.allocs_by_node(parts[2])
                self._send(200, {"allocs": [codec.encode(a)
                                            for a in allocs],
                                 "index": index}, index)
            elif parts == ["v1", "deployments"]:
                self._send(200, self._visible(acl, state.deployments(),
                                              CAP_READ_JOB), index)
            elif parts == ["v1", "services"]:
                names = self.nomad.service_names(None if ns == "*" else ns)
                self._send(200, [n for n in names
                                 if acl.allow_namespace_op(
                                     n["namespace"], CAP_READ_JOB)], index)
            elif parts[:2] == ["v1", "service"] and len(parts) == 3:
                if ns == "*":
                    regs = [r for r in state.service_registrations(None)
                            if r.service_name == parts[2]]
                    return self._send(200, self._visible(
                        acl, regs, CAP_READ_JOB), index)
                self._send(200, state.services_by_name(ns, parts[2]), index)
            elif parts == ["v1", "namespaces"]:
                self._send(200, [n for n in state.namespaces()
                                 if acl.allow_namespace(n.name)], index)
            elif parts[:2] == ["v1", "namespace"] and len(parts) == 3:
                # the ACL first: a 403 and a 404 would tell existence
                if not self._check(acl.allow_namespace(parts[2])):
                    return
                n = state.namespace_by_name(parts[2])
                if n is None:
                    return self._error(404, "namespace not found")
                self._send(200, n, index)
            elif parts == ["v1", "scaling", "policies"]:
                job_filter = q.get("job", [None])[0]
                pols = state.scaling_policies(None if ns == "*" else ns)
                if job_filter:
                    pols = [p for p in pols if p.job_id == job_filter]
                self._send(200, pols, index)
            elif parts[:3] == ["v1", "scaling", "policy"] and \
                    len(parts) == 4:
                pol = state.scaling_policy_by_id(parts[3])
                if pol is None:
                    return self._error(404, "policy not found")
                # checked in the POLICY's namespace: ids can be guessed
                if not self._check(acl.allow_namespace_op(
                        pol.namespace, CAP_READ_SCALING_POLICY)):
                    return
                self._send(200, pol, index)
            elif parts == ["v1", "operator", "snapshot"]:
                # the archive holds ACL secrets: management only
                if not self._check(acl.is_management()):
                    return
                self._send_bytes(self.nomad.snapshot_save())
            elif parts == ["v1", "event", "stream"]:
                since = int(q.get("index", ["0"])[0])
                self._send(200, self.nomad.events_since(since), index)
            elif parts == ["v1", "operator", "scheduler", "configuration"]:
                self._send(200, state.scheduler_config(), index)
            elif parts == ["v1", "operator", "faults"]:
                from ..faultinject import faults
                self._send(200, faults.snapshot())
            elif parts == ["v1", "operator", "quality"]:
                from ..server.quality import observatory
                self._send(200, observatory.report())
            elif parts == ["v1", "agent", "self"]:
                self._send(200, self._agent_self())
            elif parts[:3] == ["v1", "agent", "trace"] and \
                    len(parts) in (3, 4):
                self._get_trace(parts, q)
            elif parts == ["v1", "agent", "health"]:
                self._send(200, {"server": {"ok": True}})
            elif parts == ["v1", "metrics"]:
                if q.get("format", [""])[0] == "prometheus":
                    self._send_prometheus()
                else:
                    self._send(200, self._metrics())
            elif parts == ["v1", "status", "leader"]:
                self._send(200, "local")
            else:
                self._error(404, f"unknown path {url.path}")
        except BrokenPipeError:
            pass
        except Exception as e:  # noqa: BLE001 -- a handler answers 500
            self._error(500, f"{type(e).__name__}: {e}")

    def _get_job_sub(self, ns: str, job_id: str, sub: str, path: str,
                     index: int) -> None:
        state = self.nomad.state
        if sub == "allocations":
            self._send(200, state.allocs_by_job(ns, job_id), index)
        elif sub == "evaluations":
            self._send(200, state.evals_by_job(ns, job_id), index)
        elif sub == "summary":
            # (upstream: structs.JobSummary; here computed on read from
            # the allocs and the latest eval's queued counts)
            job = state.job_by_id(ns, job_id)
            if job is None:
                return self._error(404, "job not found")
            summary = {tg.name: {
                "queued": 0, "starting": 0, "running": 0,
                "complete": 0, "failed": 0, "lost": 0, "unknown": 0,
            } for tg in job.task_groups}
            for a in state.allocs_by_job(ns, job_id):
                row = summary.get(a.task_group)
                if row is None:
                    continue
                cs = a.client_status or "pending"
                key = {"pending": "starting", "running": "running",
                       "complete": "complete", "failed": "failed",
                       "lost": "lost", "unknown": "unknown"}.get(
                           cs, "unknown")
                if a.server_terminal_status() and key in (
                        "starting", "running"):
                    continue
                row[key] += 1
            evs = sorted(state.evals_by_job(ns, job_id),
                         key=lambda e: e.modify_index, reverse=True)
            if evs and evs[0].queued_allocations:
                for tg_name, n_q in evs[0].queued_allocations.items():
                    if tg_name in summary:
                        summary[tg_name]["queued"] = int(n_q)
            self._send(200, {"job_id": job_id, "namespace": ns,
                             "summary": summary}, index)
        elif sub == "deployment":
            self._send(200, state.latest_deployment_by_job(ns, job_id),
                       index)
        elif sub == "versions":
            versions = self.nomad.job_versions(ns, job_id)
            if not versions:
                return self._error(404, "job not found")
            self._send(200, {"versions": versions}, index)
        elif sub == "scale":
            status = self.nomad.job_scale_status(ns, job_id)
            if status is None:
                return self._error(404, "job not found")
            self._send(200, status, index)
        else:
            self._error(404, f"unknown path {path}")

    def _agent_self(self) -> dict:
        """(upstream: agent_endpoint.go AgentSelfRequest) The config and
        every stats block the reference's carries (:907-997) but
        ``shardcheck``, which the port has no counterpart of yet."""
        from .. import jitcheck, lockcheck, schedcheck, statecheck
        from ..solver import guard, xferobs

        cfg = self.nomad.state.scheduler_config()
        return {
            "config": {
                "region": getattr(self.nomad, "region", "global"),
                "version": "nomad-tpu",
                "server": {"enabled": True, "raft": False},
                "scheduler_algorithm":
                    cfg.scheduler_algorithm if cfg else "",
            },
            "stats": {
                "nomad": {"leader": "true"},
                "solver_guard": guard.state(),
                "xferobs": xferobs.state(),
                "node_flaps": self.nomad.flaps.state(),
                "worker_pool": self.nomad.supervisor.state(),
                "eval_quarantine": self.nomad.broker.quarantine_state(),
                "lockcheck": lockcheck.state(),
                "jitcheck": jitcheck.state(sites=True),
                "statecheck": statecheck.state(),
                "schedcheck": schedcheck.state(),
            },
            "member": {"name": getattr(self.nomad, "name", "local"),
                       "status": "alive"},
        }

    def _get_trace(self, parts, q) -> None:
        """The eval-scoped span recorder (server/tracing.py): one trace
        by eval id, the retained traces (?degraded=1&slowest=N&limit=),
        or all of them as chrome://tracing JSON (?format=chrome)."""
        from ..server.tracing import tracer
        if len(parts) == 4:
            tr = tracer.get(parts[3])
            if tr is None:
                return self._error(
                    404, f"no trace retained for eval {parts[3]!r}")
            return self._send(200, tr)
        if q.get("format", [""])[0] == "chrome":
            return self._send(200, tracer.chrome_trace())
        try:
            slowest = int(q.get("slowest", ["0"])[0])
            limit = int(q.get("limit", ["50"])[0])
        except ValueError:
            return self._error(400, "slowest/limit must be numeric")
        degraded = q.get("degraded", ["0"])[0] in ("1", "true")
        self._send(200, {
            "traces": tracer.list_traces(
                degraded=degraded, slowest=slowest, limit=limit),
            "stats": tracer.stats()})

    # ------------------------------------------------------------------
    def do_PUT(self):  # noqa: N802
        self.do_POST()

    def do_POST(self):  # noqa: N802
        url = urlparse(self.path)
        parts = [p for p in url.path.split("/") if p]
        try:
            q = parse_qs(url.query)
            ns = q.get("namespace", ["default"])[0]
            acl = self._acl()
            if parts[:2] == ["v1", "acl"]:
                return self._acl_post(parts, acl)
            # the blanket checks before the body is read (reference
            # :1112-1125): the node agent's paths and the node
            # operations need node:write, the operator's and the
            # system's operator:write
            if parts == ["v1", "jobs", "parse"]:
                if not self._check(acl.allow_namespace_op(ns,
                                                          CAP_PARSE_JOB)):
                    return
            elif parts[1:2] == ["node"]:
                if not self._check(acl.allow_node_write()):
                    return
            elif parts[1:2] in (["operator"], ["system"]):
                if not self._check(acl.allow_operator_write()):
                    return
            if parts[:2] == ["v1", "search"]:
                return self._search(parts, acl, ns)
            if parts == ["v1", "jobs", "parse"]:
                # (upstream: /v1/jobs/parse, HCL -> api.Job JSON)
                from ..jobspec import parse as parse_jobspec
                body = self._body()
                self._send(200, parse_jobspec(body.get("job_hcl", ""),
                                              body.get("variables") or {}))
            elif parts == ["v1", "jobs"]:
                job = self._job_from_body(self._body())
                if not job.id:
                    return self._error(400, "job id required")
                # checked in the JOB's namespace, not the query's
                if not self._check(acl.allow_namespace_op(job.namespace,
                                                          CAP_SUBMIT_JOB)):
                    return
                try:
                    ev = self.nomad.register_job(job)
                except ValueError as e:
                    return self._error(400, str(e))
                self._send(200, {"eval_id": ev.id if ev else "",
                                 "job_modify_index": job.job_modify_index})
            elif parts[:2] == ["v1", "job"] and len(parts) == 4 and \
                    parts[3] == "revert":
                if not self._check(acl.allow_namespace_op(ns,
                                                          CAP_SUBMIT_JOB)):
                    return
                body = self._body()
                try:
                    ev = self.nomad.revert_job(
                        ns, parts[2], int(body.get("job_version", 0)),
                        body.get("enforce_prior_version"))
                except ValueError as e:
                    return self._error(400, str(e))
                self._send(200, {"eval_id": ev.id if ev else ""})
            elif parts[:2] == ["v1", "job"] and len(parts) == 4 and \
                    parts[3] == "stable":
                if not self._check(acl.allow_namespace_op(ns,
                                                          CAP_SUBMIT_JOB)):
                    return
                body = self._body()
                try:
                    self.nomad.set_job_stability(
                        ns, parts[2], int(body.get("job_version", 0)),
                        bool(body.get("stable", True)))
                except (TypeError, ValueError) as e:
                    return self._error(400, str(e))
                self._send(200, {"updated": True})
            elif parts[:2] == ["v1", "job"] and len(parts) == 5 and \
                    parts[3] == "periodic" and parts[4] == "force":
                # (upstream: periodic_endpoint.go Force)
                if not self._check(acl.allow_namespace_op(ns,
                                                          CAP_SUBMIT_JOB)):
                    return
                try:
                    child = self.nomad.periodic_force(ns, parts[2])
                except ValueError as e:
                    return self._error(400, str(e))
                self._send(200, {"dispatched_job_id": child})
            elif parts[:2] == ["v1", "job"] and len(parts) == 4 and \
                    parts[3] in ("plan", "dispatch", "scale"):
                self._post_job_op(acl, ns, parts[2], parts[3])
            elif parts == ["v1", "operator", "snapshot"]:
                # a restore installs any ACL state: management only
                if not self._check(acl.is_management()):
                    return
                try:
                    meta = self.nomad.snapshot_restore(self._raw_body())
                except ValueError as e:
                    return self._error(400, str(e))
                self._send(200, {"restored": True, "index": meta["index"]})
            elif parts == ["v1", "node", "register"]:
                from ..structs import Node, codec
                node = codec.decode(Node, self._body().get("node", {}))
                self.nomad.register_node(node)
                self._send(200, {"node_id": node.id,
                                 "heartbeat_ttl":
                                     self.nomad.heartbeat_ttl})
            elif parts == ["v1", "node", "services-register"]:
                from typing import List
                from ..structs import ServiceRegistration, codec
                regs = codec.decode(List[ServiceRegistration],
                                    self._body().get("services", []))
                self.nomad.upsert_services(regs)
                self._send(200, {"registered": len(regs)})
            elif parts == ["v1", "node", "allocs-update"]:
                from typing import List
                from ..structs import Allocation, codec
                allocs = codec.decode(List[Allocation],
                                      self._body().get("allocs", []))
                self.nomad.update_allocs_from_client(allocs)
                self._send(200, {"updated": len(allocs)})
            elif parts == ["v1", "namespace"] or (
                    parts[:2] == ["v1", "namespace"] and len(parts) == 3):
                # (upstream: namespace_endpoint.go UpsertNamespaces, a
                # management operation)
                if not self._check(acl.is_management()):
                    return
                self._post_namespace(parts)
            elif parts == ["v1", "node", "pools"] or (
                    parts[:3] == ["v1", "node", "pool"] and len(parts) == 4
                    and parts[3] != "heartbeat"):
                self._post_node_pool(parts)
            elif parts[:2] == ["v1", "node"] and len(parts) == 4:
                self._post_node(parts[2], parts[3], url.path)
            elif parts[:2] == ["v1", "deployment"] and len(parts) == 4:
                self._post_deployment(acl, parts[2], parts[3], url.path)
            elif parts[:2] == ["v1", "allocation"] and len(parts) == 4 \
                    and parts[3] == "stop":
                # (upstream: alloc_endpoint.go Stop)
                alloc = self.nomad.state.alloc_by_id(parts[2])
                if alloc is None:
                    return self._error(404, "alloc not found")
                if not self._check(acl.allow_namespace_op(
                        alloc.namespace, CAP_ALLOC_LIFECYCLE)):
                    return
                self._send(200, {"eval_id": self.nomad.stop_alloc(parts[2])})
            elif parts == ["v1", "agent", "torch-profile"]:
                # it writes where the caller says: agent:write
                if not self._check(acl.allow_agent_write()):
                    return
                self._torch_profile()
            elif parts == ["v1", "system", "gc"]:
                self._send(200, self.nomad.run_gc_once())
            elif parts == ["v1", "operator", "solver", "reprobe"]:
                # the guard's recovery check: a flag read and a killable
                # subprocess probe, so a wedged init cannot hang this
                from ..solver import guard
                try:
                    timeout = float(q.get("timeout", ["0"])[0]) or None
                except ValueError:
                    timeout = None
                self._send(200, guard.reprobe(timeout))
            elif parts == ["v1", "operator", "faults"]:
                self._post_faults()
            elif parts == ["v1", "operator", "quarantine"]:
                # release poison evals: {"eval_id": ...} for one,
                # {"release_all": true} for all
                body = self._body()
                if body.get("release_all"):
                    released = self.nomad.broker.release_quarantined()
                elif body.get("eval_id"):
                    released = self.nomad.broker.release_quarantined(
                        body["eval_id"])
                else:
                    return self._error(
                        400, "eval_id or release_all required")
                self._send(200, {
                    "released": released,
                    "quarantine": self.nomad.broker.quarantine_state()})
            elif parts == ["v1", "operator", "scheduler", "configuration"]:
                body = self._body()
                cfg = SchedulerConfiguration(
                    scheduler_algorithm=body.get("scheduler_algorithm",
                                                 "binpack"),
                    memory_oversubscription_enabled=body.get(
                        "memory_oversubscription_enabled", False),
                    pause_eval_broker=bool(body.get("pause_eval_broker",
                                                    False)))
                self.nomad.apply_scheduler_config(cfg)
                self._send(200, {"updated": True})
            else:
                self._error(404, f"unknown path {url.path}")
        except Exception as e:  # noqa: BLE001 -- a handler answers 500
            self._error(500, f"{type(e).__name__}: {e}")

    def _post_job_op(self, acl, ns: str, job_id: str, op: str) -> None:
        """(upstream: job_endpoint.go Plan, Dispatch, Scale) A dry run of
        a JSON or HCL job, checked in the job's namespace; a dispatch
        with a base64 payload; a scale of the group named by
        ``target.Group``. A refusal answers 400."""
        import base64
        cap = {"plan": None, "dispatch": CAP_DISPATCH_JOB,
               "scale": CAP_SCALE_JOB}[op]
        if cap is not None and \
                not self._check(acl.allow_namespace_op(ns, cap)):
            return
        body = self._body()
        job = None
        if op == "plan":
            # a jobspec that does not parse answers 500, as the
            # reference's
            job = self._job_from_body(body)
            if not self._check(acl.allow_namespace_op(job.namespace,
                                                      CAP_SUBMIT_JOB)):
                return
        try:
            if op == "plan":
                reply = self.nomad.plan_job(job)
            elif op == "dispatch":
                payload = base64.b64decode(body.get("payload", "") or "")
                child, ev = self.nomad.dispatch_job(
                    ns, job_id, payload, body.get("meta") or {},
                    body.get("idempotency_token", ""))
                reply = {"dispatched_job_id": child.id,
                         "eval_id": ev.id if ev else ""}
            else:
                target = body.get("target") or {}
                group = target.get("Group", target.get("group", ""))
                ev = self.nomad.scale_job(
                    ns, job_id, group,
                    count=(int(body["count"])
                           if body.get("count") is not None else None),
                    message=body.get("message", ""),
                    error=bool(body.get("error", False)),
                    meta=body.get("meta"))
                reply = {"eval_id": ev.id if ev else ""}
        except ValueError as e:     # binascii.Error is one
            return self._error(400, str(e))
        self._send(200, reply)

    def _post_namespace(self, parts) -> None:
        """(reference :1366) An upsert from the body, named by the body
        or the path."""
        from ..structs import Namespace, NamespaceNodePoolConfiguration
        body = self._body()
        npc = body.get("node_pool_configuration") or {}
        namespace = Namespace(
            name=body.get("name", parts[2] if len(parts) == 3 else ""),
            description=body.get("description", ""),
            quota=body.get("quota", ""),
            meta=body.get("meta") or {},
            node_pool_configuration=NamespaceNodePoolConfiguration(
                default=npc.get("default", ""),
                allowed=npc.get("allowed") or [],
                denied=npc.get("denied") or []))
        try:
            self.nomad.upsert_namespace(namespace)
        except ValueError as e:
            return self._error(400, str(e))
        self._send(200, {"updated": True})

    def _post_node_pool(self, parts) -> None:
        """(reference :1391) An upsert from the body, named by the body
        or the path."""
        from ..structs import NodePool
        body = self._body()
        pool = NodePool(
            name=body.get("name", parts[3] if len(parts) == 4 else ""),
            description=body.get("description", ""),
            meta=body.get("meta") or {},
            scheduler_algorithm=body.get("scheduler_algorithm", ""))
        try:
            self.nomad.upsert_node_pool(pool)
        except ValueError as e:
            return self._error(400, str(e))
        self._send(200, {"updated": True})

    def _post_node(self, node_id: str, op: str, path: str) -> None:
        if op == "heartbeat":
            ttl = self.nomad.heartbeat(node_id)
            if not ttl:
                # an unknown node must register again (upstream:
                # heartbeats to unknown nodes fail so the client does)
                return self._error(404, "node not found")
            self._send(200, {"heartbeat_ttl": ttl})
        elif op == "purge":
            # (upstream: node_endpoint.go Deregister, `nomad node purge`)
            try:
                self.nomad.deregister_node(node_id)
            except ValueError as e:
                return self._error(404, str(e))
            self._send(200, {"purged": node_id})
        elif op == "drain":
            from ..structs import DrainStrategy
            body = self._body()
            strategy = None
            if body.get("drain_spec") is not None:
                strategy = DrainStrategy(
                    deadline_s=body["drain_spec"].get("deadline_s", 3600))
            self.nomad.drain_node(node_id, strategy)
            self._send(200, {"updated": True})
        elif op == "eligibility":
            body = self._body()
            self.nomad.state.update_node_eligibility(
                node_id, body.get("eligibility", "eligible"))
            self._send(200, {"updated": True})
        else:
            self._error(404, f"unknown path {path}")

    def _post_deployment(self, acl, op: str, dep_id: str,
                         path: str) -> None:
        """(upstream: deployment_endpoint.go Pause, Fail, Promote),
        checked in the deployment's namespace."""
        if op not in ("pause", "fail", "promote"):
            return self._error(404, f"unknown path {path}")
        d = self.nomad.state.deployment_by_id(dep_id)
        if d is None:
            return self._error(404, "unknown deployment")
        if not self._check(acl.allow_namespace_op(d.namespace,
                                                  CAP_SUBMIT_JOB)):
            return
        body = self._body()
        try:
            if op == "pause":
                self.nomad.pause_deployment(dep_id,
                                            bool(body.get("pause", True)))
                reply = {"paused": True}
            elif op == "fail":
                self.nomad.fail_deployment(dep_id)
                reply = {"failed": True}
            else:
                self.nomad.promote_deployment(dep_id, body.get("groups"))
                reply = {"promoted": True}
        except ValueError as e:
            return self._error(400, str(e))
        self._send(200, reply)

    def _post_faults(self) -> None:
        """Arm or disarm a fault point: {"point", "action", "delay_s",
        "count"} arms; {"point", "disarm": true} or {"disarm_all": true}
        clears."""
        from ..faultinject import faults
        body = self._body()
        try:
            if body.get("disarm_all"):
                faults.disarm_all()
            elif body.get("disarm"):
                if not body.get("point"):
                    return self._error(400, "point required")
                faults.disarm(body["point"])
            else:
                faults.arm(body.get("point", ""),
                           body.get("action", "error"),
                           delay_s=float(body.get("delay_s", 0.0)),
                           count=body.get("count"))
        except (ValueError, TypeError) as e:
            return self._error(400, str(e))
        self._send(200, faults.snapshot())

    def _torch_profile(self) -> None:
        """{"action": "start"|"stop", "dir": ...}: the profiler held on
        the agent (TorchProfile). CUDA is profiled on a card agent only.
        A second start, or a stop without one, answers 400."""
        body = self._body()
        action = str(body.get("action", ""))
        trace_dir = str(body.get("dir", "")) or TORCH_TRACE_DIR
        prof = self.server.torch_profile
        try:
            if action == "start":
                device = getattr(self.nomad, "device", None)
                prof.start(trace_dir, cuda=getattr(device, "type", "")
                           == "cuda")
                self._send(200, {"tracing": True, "dir": trace_dir})
            elif action == "stop":
                path = prof.stop()
                self._send(200, {"tracing": False, "dir": trace_dir,
                                 "trace": path})
            else:
                self._error(400, "action must be start|stop")
        except RuntimeError as e:
            self._error(400, str(e))

    def do_DELETE(self):  # noqa: N802
        url = urlparse(self.path)
        parts = [p for p in url.path.split("/") if p]
        try:
            q = parse_qs(url.query)
            ns = q.get("namespace", ["default"])[0]
            purge = q.get("purge", ["false"])[0] == "true"
            acl = self._acl()
            state = self.nomad.state
            if parts[:2] == ["v1", "job"] and len(parts) == 3:
                if not self._check(acl.allow_namespace_op(ns,
                                                          CAP_SUBMIT_JOB)):
                    return
                ev = self.nomad.deregister_job(ns, parts[2], purge=purge)
                if ev is None:
                    return self._error(404, "job not found")
                self._send(200, {"eval_id": ev.id})
            elif parts[:2] == ["v1", "acl"] and len(parts) == 4 and \
                    parts[2] in ("policy", "role", "token"):
                if not self._check(acl.is_management()):
                    return
                {"policy": state.delete_acl_policies,
                 "role": state.delete_acl_roles,
                 "token": state.delete_acl_tokens}[parts[2]]([parts[3]])
                self._send(200, {"deleted": True})
            elif parts[:2] == ["v1", "service"] and len(parts) == 4:
                # checked in the REGISTRATION's namespace once found (ids
                # can be guessed), else in the query's
                reg = next((r for r in state.service_registrations(None)
                            if r.id == parts[3]), None)
                if reg is None or reg.service_name != parts[2]:
                    if not self._check(acl.allow_namespace_op(
                            ns, CAP_SUBMIT_JOB)):
                        return
                    return self._error(404, "registration not found")
                if not self._check(acl.allow_namespace_op(reg.namespace,
                                                          CAP_SUBMIT_JOB)):
                    return
                state.delete_service_registrations([parts[3]])
                self._send(200, {"deleted": True})
            elif parts[:2] == ["v1", "namespace"] and len(parts) == 3:
                if not self._check(acl.is_management()):
                    return
                try:
                    self.nomad.delete_namespace(parts[2])
                except ValueError as e:
                    return self._error(400, str(e))
                self._send(200, {"deleted": True})
            elif parts[:3] == ["v1", "node", "pool"] and len(parts) == 4:
                if not self._check(acl.allow_node_write()):
                    return
                try:
                    self.nomad.delete_node_pool(parts[3])
                except ValueError as e:
                    return self._error(400, str(e))
                self._send(200, {"deleted": True})
            else:
                self._error(404, f"unknown path {url.path}")
        except Exception as e:  # noqa: BLE001 -- a handler answers 500
            self._error(500, f"{type(e).__name__}: {e}")

    # ------------------------------------------------------------------
    # ACL enforcement (upstream: command/agent/http.go wrap() reads the
    # token; each endpoint checks its capabilities)
    def _acl(self):
        """The request's compiled ACL: its X-Nomad-Token, else ?token=."""
        secret = self.headers.get("X-Nomad-Token", "")
        if not secret:
            q = parse_qs(urlparse(self.path).query)
            if "token" in q:
                secret = q["token"][0]
        compiled, _token = self.nomad.resolve_token(secret or None)
        return compiled

    def _check(self, allowed: bool) -> bool:
        """False, with the 403 sent, when the request is refused."""
        if allowed:
            return True
        self._error(403, "Permission denied")
        return False

    @staticmethod
    def _ns_allowed(acl, ns: str, cap: str) -> bool:
        """``cap`` in namespace ``ns``; in any namespace for "*"."""
        return (acl.allow_any_namespace(cap) if ns == "*"
                else acl.allow_namespace_op(ns, cap))

    @staticmethod
    def _visible(acl, rows, cap: str) -> list:
        """The rows (with a ``namespace``) whose namespace grants
        ``cap``; all of them under the management ACL."""
        if acl.is_management():
            return rows
        return [r for r in rows if acl.allow_namespace_op(r.namespace, cap)]

    # -- /v1/acl (upstream: nomad/acl_endpoint.go,
    #    command/agent/acl_endpoint.go) ----------------------------------
    @staticmethod
    def _token_stub(t) -> dict:
        return {"accessor_id": t.accessor_id, "name": t.name,
                "type": t.type, "policies": t.policies,
                "global": t.global_token, "create_time": t.create_time,
                "modify_index": t.modify_index}

    def _acl_get(self, parts, acl, index) -> None:
        """(reference :1850) Every read is management only but
        token/self, which any token reads (its own record)."""
        state = self.nomad.state
        if parts == ["v1", "acl", "policies"]:
            self._send(200, [{"name": p.name, "description": p.description,
                              "modify_index": p.modify_index}
                             for p in state.acl_policies()], index)
        elif parts[:3] == ["v1", "acl", "policy"] and len(parts) == 4:
            p = state.acl_policy_by_name(parts[3])
            if p is None:
                return self._error(404, "policy not found")
            self._send(200, p, index)
        elif parts == ["v1", "acl", "roles"]:
            self._send(200, state.acl_roles(), index)
        elif parts[:3] == ["v1", "acl", "role"] and len(parts) == 4:
            r = state.acl_role_by_name(parts[3])
            if r is None:
                return self._error(404, "role not found")
            self._send(200, r, index)
        elif parts == ["v1", "acl", "tokens"]:
            self._send(200, [self._token_stub(t)
                             for t in state.acl_tokens()], index)
        elif parts == ["v1", "acl", "token", "self"]:
            secret = self.headers.get("X-Nomad-Token", "")
            if not secret:
                q = parse_qs(urlparse(self.path).query)
                secret = q.get("token", [""])[0]
            # resolved through the server, so an expired token is refused
            _compiled, token = self.nomad.resolve_token(secret or None)
            if token is None:
                return self._error(404, "token not found")
            self._send(200, token, index)
        elif parts[:3] == ["v1", "acl", "token"] and len(parts) == 4:
            t = state.acl_token_by_accessor(parts[3])
            if t is None:
                return self._error(404, "token not found")
            self._send(200, t, index)
        else:
            self._error(404, "unknown acl path")

    def _acl_post(self, parts, acl) -> None:
        """(reference :1901) bootstrap (open until done), and the
        management writes of policies, tokens and roles."""
        from ..acl import parse_policy
        from ..structs import ACLPolicy, ACLRole, ACLToken
        state = self.nomad.state
        if parts == ["v1", "acl", "bootstrap"]:
            token = self.nomad.bootstrap_acl()
            if token is None:
                return self._error(400, "ACL already bootstrapped")
            return self._send(200, token)
        if not (parts[:3] in (["v1", "acl", "policy"],
                              ["v1", "acl", "role"]) and len(parts) == 4
                or parts == ["v1", "acl", "token"]):
            return self._error(404, "unknown acl path")
        if not self._check(acl.is_management()):
            return
        body = self._body()
        if parts[2] == "policy":
            rules = body.get("rules", "")
            try:
                parse_policy(parts[3], rules)   # refused before stored
            except Exception as e:  # noqa: BLE001 -- any parse error
                return self._error(400, f"invalid policy: {e}")
            state.upsert_acl_policies([ACLPolicy(
                name=parts[3], description=body.get("description", ""),
                rules=rules)])
            self._send(200, {"updated": True})
        elif parts[2] == "token":
            token = ACLToken.new(
                name=body.get("name", ""),
                type=body.get("type", "client"),
                policies=body.get("policies", []),
                roles=body.get("roles", []),
                ttl_s=body.get("ttl_s"))
            state.upsert_acl_tokens([token])
            self._send(200, token)
        else:
            # (upstream: acl_endpoint.go UpsertRoles)
            policies = [str(p) for p in body.get("policies", [])]
            for p in policies:
                if state.acl_policy_by_name(p) is None:
                    return self._error(
                        400, f"role links unknown policy {p!r}")
            state.upsert_acl_roles([ACLRole(
                name=parts[3], description=body.get("description", ""),
                policies=policies)])
            self._send(200, {"updated": True})

    # -- /v1/search (upstream: command/agent/search_endpoint.go) ---------
    def _search(self, parts, acl, ns: str) -> None:
        """Prefix or fuzzy search over the contexts the token may read
        (upstream: filteredSearchContexts), objects filtered by the
        token's read-job in their namespace."""
        body = self._body()
        allowed = self._allowed_search_contexts(acl, ns)
        ns_allowed = (None if acl.is_management()
                      else (lambda n: acl.allow_namespace_op(
                          n, CAP_READ_JOB)))
        if parts == ["v1", "search"]:
            reply = self.nomad.search(
                body.get("prefix", ""), body.get("context", "all") or "all",
                ns, allowed_contexts=allowed, ns_allowed=ns_allowed)
        elif parts == ["v1", "search", "fuzzy"]:
            reply = self.nomad.fuzzy_search(
                body.get("text", ""), body.get("context", "all") or "all",
                ns, allowed_contexts=allowed, ns_allowed=ns_allowed)
        else:
            return self._error(404, "unknown search path")
        self._send(200, reply)

    def _allowed_search_contexts(self, acl, ns: str):
        """The contexts the token may search (reference :2099; upstream:
        search_endpoint.go sufficientSearchPerms); None, unfiltered, for
        management."""
        if acl.is_management():
            return None
        from ..server.search import (
            CONTEXT_ALLOCS, CONTEXT_DEPLOYMENTS, CONTEXT_EVALS,
            CONTEXT_JOBS, CONTEXT_NAMESPACES, CONTEXT_NODE_POOLS,
            CONTEXT_NODES, CONTEXT_PLUGINS, CONTEXT_SCALING_POLICIES,
            CONTEXT_VARIABLES, CONTEXT_VOLUMES)
        allowed = []
        if self._ns_allowed(acl, ns, CAP_READ_JOB) or \
                self._ns_allowed(acl, ns, CAP_LIST_JOBS):
            allowed += [CONTEXT_JOBS, CONTEXT_EVALS, CONTEXT_ALLOCS,
                        CONTEXT_DEPLOYMENTS, CONTEXT_VOLUMES,
                        CONTEXT_PLUGINS, CONTEXT_NAMESPACES]
        if acl.allow_node_read():
            allowed += [CONTEXT_NODES, CONTEXT_NODE_POOLS]
        if self._ns_allowed(acl, ns, CAP_LIST_SCALING_POLICIES):
            allowed += [CONTEXT_SCALING_POLICIES]
        if acl.allow_variable_op(ns if ns != "*" else "default", "", "list"):
            allowed += [CONTEXT_VARIABLES]
        return allowed

    # ------------------------------------------------------------------
    def _write_chunk(self, payload: bytes) -> None:
        """One HTTP/1.1 chunked-transfer frame."""
        self.wfile.write(f"{len(payload):x}\r\n".encode())
        self.wfile.write(payload + b"\r\n")
        self.wfile.flush()

    def _stream_events(self, q, since: int) -> None:
        """Chunked NDJSON event stream with topic filters (upstream:
        command/agent/event_endpoint.go, nomad/stream/ndjson.go):
        ?topic=Topic:Key, repeatable; a {} heartbeat every 10 s."""
        topics: dict = {}
        for t in q.get("topic", []):
            name, _, key = t.partition(":")
            topics.setdefault(name or "*", []).append(key or "*")
        sub = self.nomad.subscribe_events(topics or None, since)
        try:
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            last_beat = time.time()
            while True:
                event = sub.next(timeout=0.5)
                if event is not None:
                    self._write_chunk(
                        json.dumps(to_jsonable(event)).encode() + b"\n")
                elif time.time() - last_beat >= 10.0:
                    self._write_chunk(b"{}\n")
                    last_beat = time.time()
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass
        finally:
            sub.closed = True
            self.nomad.unsubscribe_events(sub)
            try:
                self.wfile.write(b"0\r\n\r\n")
            except OSError:
                pass

    def _job_from_body(self, body: dict):
        """A JSON jobspec or inline HCL (upstream: the job endpoints take
        api.Job; parsing is its own endpoint)."""
        if "job_hcl" in body:
            from ..jobspec import parse as parse_jobspec
            return parse_jobspec(body["job_hcl"],
                                 body.get("variables") or {})
        return job_from_json(body.get("job", body))

    def _job_stub(self, j) -> dict:
        return {"id": j.id, "name": j.name, "namespace": j.namespace,
                "type": j.type, "priority": j.priority, "status": j.status,
                "version": j.version, "stop": j.stop}

    def _node_stub(self, n) -> dict:
        return {"id": n.id, "name": n.name, "datacenter": n.datacenter,
                "status": n.status, "node_class": n.node_class,
                "scheduling_eligibility": n.scheduling_eligibility,
                "drain": n.drain}

    def _send_prometheus(self) -> None:
        body = prometheus_text(self._metrics()).encode()
        self.send_response(200)
        self.send_header("Content-Type",
                         "text/plain; version=0.0.4; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _metrics(self) -> dict:
        from ..server.quality import observatory
        from ..server.telemetry import metrics
        s = self.nomad
        # the quality gauges are sampled before the registry snapshot,
        # so this reply's gauge series carry the fresh values
        quality = observatory.report()
        tel = metrics.snapshot()
        counters = tel["counters"]
        tpu = counters.get("nomad.scheduler.placements_tpu", 0)
        host_fb = counters.get("nomad.scheduler.placements_host_fallback", 0)
        return {
            "broker": s.broker.stats(),
            "blocked_evals": s.blocked_evals.stats(),
            "plans_applied": s.planner.plans_applied,
            "plans_rejected": s.planner.plans_rejected,
            "state_index": s.state.latest_index(),
            "samples": tel["samples"],
            "gauges": tel["gauges"],
            "counters": counters,
            # the share of tpu-* placements the kernels made
            "tpu_placement_ratio": (tpu / (tpu + host_fb)
                                    if (tpu + host_fb) else None),
            "quality": _quality_metrics_block(quality),
        }


def _quality_metrics_block(q: dict) -> dict:
    """The headline slice of the quality report for /v1/metrics (the full
    report is /v1/operator/quality)."""
    if not q.get("enabled"):
        return {"enabled": False}
    p = q.get("placement") or {}
    a = q.get("audit") or {}
    sat = q.get("saturation") or {}
    out = {"enabled": True, "attached": q.get("attached", False)}
    if p.get("attached"):
        out["fragmentation_index"] = p["fragmentation_index"]
        out["packing_efficiency"] = p["packing_efficiency"]
        out["live_allocs"] = p["fleet"]["live_allocs"]
    out["score_drift_max"] = a.get("score_drift_max", 0.0)
    out["decision_mismatch_total"] = a.get("decision_mismatch_total", 0)
    out["audit_alert"] = a.get("alert")
    out["bottleneck"] = sat.get("bottleneck")
    return out


def prometheus_text(m: dict) -> str:
    """The Prometheus text form of a /v1/metrics dict (upstream: the
    go-metrics prometheus sink, command/agent/command.go:1164-1253):
    counters, then every key of telemetry's TIMER_ / GAUGE_SUMMARY_KEYS
    of each timer and gauge as a gauge series, then the applier and
    index gauges."""
    from ..server.telemetry import GAUGE_SUMMARY_KEYS, TIMER_SUMMARY_KEYS

    def norm(name: str) -> str:
        return "".join(ch if ch.isalnum() or ch == "_" else "_"
                       for ch in name)

    lines = []
    for name, value in sorted(m.get("counters", {}).items()):
        p = norm(name)
        lines.append(f"# TYPE {p} counter")
        lines.append(f"{p} {value}")
    for name, s in sorted(m.get("samples", {}).items()):
        p = norm(name)
        for k in TIMER_SUMMARY_KEYS:
            if k in s:
                lines.append(f"# TYPE {p}_{k} gauge")
                lines.append(f"{p}_{k} {s[k]}")
    for name, s in sorted(m.get("gauges", {}).items()):
        p = norm(name)
        for k in GAUGE_SUMMARY_KEYS:
            if k in s:
                lines.append(f"# TYPE {p}_{k} gauge")
                lines.append(f"{p}_{k} {s[k]}")
    for k in ("plans_applied", "plans_rejected", "state_index"):
        if k not in m:
            continue
        p = norm(f"nomad.{k}")
        lines.append(f"# TYPE {p} gauge")
        lines.append(f"{p} {m[k]}")
    if m.get("tpu_placement_ratio") is not None:
        lines.append("# TYPE nomad_scheduler_tpu_placement_ratio gauge")
        lines.append("nomad_scheduler_tpu_placement_ratio "
                     f"{m['tpu_placement_ratio']}")
    return "\n".join(lines) + "\n"


class HttpServer:
    """(upstream: command/agent/http.go:179) The API over one port
    Server, on ``port`` (0 binds a free one: read ``self.port``), TLS
    when ``tls.enable_http``."""

    def __init__(self, nomad_server, host: str = "127.0.0.1",
                 port: int = 4646, tls=None):
        self.httpd = ThreadingHTTPServer((host, port), ApiHandler)
        self.httpd.nomad_server = nomad_server
        self.httpd.torch_profile = TorchProfile()
        self.tls = tls
        if tls is not None and tls.enable_http:
            from ..tlsutil import server_context
            self.httpd.socket = server_context(tls).wrap_socket(
                self.httpd.socket, server_side=True)
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True, name="http-api")
        self._thread.start()

    def shutdown(self) -> None:
        if self._thread is not None:
            # stops serve_forever; waits for it forever if it never ran
            self.httpd.shutdown()
        # close the listener too: a bound port would queue connections
        # in its backlog instead of refusing them
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
