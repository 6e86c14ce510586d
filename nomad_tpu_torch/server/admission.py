"""Job admission pipeline: mutate-then-validate hooks applied before a job
reaches the store (port of nomad_tpu/server/admission.py; upstream:
nomad/job_endpoint_hooks.go, the chain Job.Register runs at
nomad/job_endpoint.go:96). Vault and Consul token derivation map to the
native secrets model: workload identities granting read access to the
job's own Variables subtree (nomad/jobs/<job_id>...).

``ConnectHook`` adds sidecar tasks, which change a group's asks, so the
server runs the pipeline before the job is stored.
"""
from __future__ import annotations

import re
from typing import List, Tuple

from ..structs import Job

# a template's reference to a Variable: {{ nomad_var "path" "field" }}
NOMAD_VAR_RE = re.compile(
    r"\{\{\s*nomad_var\s+\"([^\"]+)\"\s+\"([^\"]+)\"\s*\}\}")

WORKLOAD_VAR_PREFIX = "nomad/jobs/"


def job_variable_prefix(job_id: str) -> str:
    """The Variables subtree a job's workload identity may read."""
    return f"{WORKLOAD_VAR_PREFIX}{job_id}"


class AdmissionHook:
    name = "hook"

    def mutate(self, job: Job) -> Tuple[Job, List[str]]:
        """-> (job, warnings)"""
        return job, []

    def validate(self, job: Job, server) -> List[str]:
        """-> warnings; raise ValueError to reject."""
        return []


class ImplicitIdentityHook(AdmissionHook):
    """Tasks that consume secrets (a vault block or nomad_var template
    references) get an implicit identity requirement (upstream:
    job_endpoint_hooks.go jobImplicitIdentitiesHook)."""

    name = "implicit-identity"

    def mutate(self, job: Job) -> Tuple[Job, List[str]]:
        for tg in job.task_groups:
            for task in tg.tasks:
                needs = task.vault is not None or any(
                    NOMAD_VAR_RE.search(str(t.get("data", "")))
                    for t in (task.templates or []))
                if needs and not getattr(task, "identity", None):
                    task.identity = {"file": True, "env": False}
        return job, []


class VaultHook(AdmissionHook):
    """The vault-block equivalent: ``task.vault = {"path": ...,
    "destination": ...}`` materializes that Variables path into the task's
    secrets dir via an injected template (upstream: nomad/vault.go token
    derivation + taskrunner/template -- re-based on native Variables, so
    no external Vault is involved)."""

    name = "vault"

    def mutate(self, job: Job) -> Tuple[Job, List[str]]:
        warnings: List[str] = []
        for tg in job.task_groups:
            for task in tg.tasks:
                if task.vault is None:
                    continue
                # mutators run before validators: malformed blocks must
                # reject HERE with the 400-mapped error, not AttributeError
                if not isinstance(task.vault, dict):
                    raise ValueError(
                        f"task {task.name!r}: vault block must be a map")
                path = str(task.vault.get("path", "")
                           or job_variable_prefix(job.id))
                dest = str(task.vault.get("destination", "secrets/vault.env"))
                marker = f"__vault:{path}"
                templates = task.templates or []
                if any(t.get("__vault") == path for t in templates):
                    continue
                templates.append({
                    "__vault": path,
                    "data": marker,
                    "destination": dest,
                    "env_format": True,
                })
                task.templates = templates
        return job, warnings



class WorkloadVarScopeHook(AdmissionHook):
    """Templates may only reference the job's OWN Variables subtree --
    the implicit workload policy would deny anything else at runtime, so
    reject it at admission where the error is actionable (upstream: the
    implicit workload-identity ACL of variables_endpoint.go)."""

    name = "workload-var-scope"

    def validate(self, job: Job, server) -> List[str]:
        own = job_variable_prefix(job.id)
        for tg in job.task_groups:
            for task in tg.tasks:
                for tpl in task.templates or []:
                    for path, _field in NOMAD_VAR_RE.findall(
                            str(tpl.get("data", ""))):
                        # the implicit policy denies EVERYTHING outside
                        # the job's own subtree -- any other literal path
                        # is a guaranteed runtime denial
                        if "${" in path:
                            continue    # interpolated: checked at runtime
                        if path != own and not path.startswith(own + "/"):
                            raise ValueError(
                                f"task {task.name!r} template references "
                                f"{path!r}, outside this job's workload "
                                f"scope {own!r}")
        return []


class ConnectHook(AdmissionHook):
    """Service-mesh admission (upstream: job_endpoint_hook_connect.go):
    every group service with a ``connect.sidecar_service`` block gets

      - a dynamic group-network port ``connect-proxy-<svc>`` (the public
        mesh listener other allocs dial),
      - an injected ``raw_exec`` sidecar task running the client's data
        plane (the Envoy analog), configured purely through taskenv
        interpolation, and
      - a ``<svc>-sidecar-proxy`` catalog registration so upstream
        resolution targets the destination's proxy, not the service.

    Mutation is idempotent by name: resubmitting an already-admitted job
    injects nothing twice."""

    name = "connect"

    @staticmethod
    def _sidecar_block(svc):
        """The sidecar_service dict, or None. Tolerates dict-shaped
        services (defensive; job_from_json builds Service objects) and
        rejects malformed connect values with the 400-mapped error."""
        connect = (svc.get("connect") if isinstance(svc, dict)
                   else svc.connect)
        if connect is None:
            return None
        if not isinstance(connect, dict):
            raise ValueError("service connect block must be a map")
        sc = connect.get("sidecar_service")
        if sc is not None and not isinstance(sc, dict):
            raise ValueError("connect.sidecar_service must be a map")
        return sc

    def mutate(self, job: Job) -> Tuple[Job, List[str]]:
        import json as _json
        import sys as _sys

        from ..structs import NetworkResource, Port, Resources, Service, \
            Task
        for tg in job.task_groups:
            for svc in list(tg.services):
                if isinstance(svc, dict):
                    continue          # defensive: untyped service payload
                sc = self._sidecar_block(svc)
                if sc is None:
                    continue
                proxy_task = f"connect-proxy-{svc.name}"
                port_label = proxy_task
                if not tg.networks:
                    tg.networks = [NetworkResource()]
                net = tg.networks[0]
                if not any(p.label == port_label
                           for p in net.dynamic_ports):
                    net.dynamic_ports.append(Port(label=port_label))
                if not any(t.name == proxy_task for t in tg.tasks):
                    upstreams = (((sc or {}).get("proxy") or {})
                                 .get("upstreams")) or []
                    env_label = port_label.upper().replace("-", "_")
                    # command/PYTHONPATH are placeholders: the client's
                    # EnvHook re-resolves both against ITS install (the
                    # admitting server may run elsewhere)
                    env = {
                        "NOMAD_CONNECT_HTTP_ADDR":
                            "${attr.nomad.api_addr}",
                        "NOMAD_CONNECT_PUBLIC_PORT":
                            f"${{NOMAD_PORT_{env_label}}}",
                        "NOMAD_CONNECT_UPSTREAMS": _json.dumps(upstreams),
                    }
                    if svc.port_label:
                        svc_label = svc.port_label.upper().replace("-", "_")
                        env["NOMAD_CONNECT_LOCAL_PORT"] = \
                            f"${{NOMAD_PORT_{svc_label}}}"
                    tg.tasks.append(Task(
                        name=proxy_task, driver="raw_exec",
                        config={"command": _sys.executable,
                                "args": ["-m",
                                         "nomad_tpu.client.connect_proxy"]},
                        env=env,
                        resources=Resources(cpu=50, memory_mb=64),
                        lifecycle={"hook": "prestart", "sidecar": True},
                        kind=f"connect-proxy:{svc.name}"))
                sp_name = f"{svc.name}-sidecar-proxy"
                if not any(s.name == sp_name for s in tg.services):
                    tg.services.append(Service(
                        name=sp_name, port_label=port_label,
                        provider="nomad", tags=["connect-proxy"]))
        return job, []

    def validate(self, job: Job, server) -> List[str]:
        for tg in job.task_groups:
            binds = set()
            for svc in tg.services:
                sc = self._sidecar_block(svc)
                if sc is None:
                    continue
                sname = (svc.get("name", "") if isinstance(svc, dict)
                         else svc.name)
                ups = (((sc or {}).get("proxy") or {})
                       .get("upstreams")) or []
                for up in ups:
                    if not isinstance(up, dict):
                        raise ValueError(
                            f"service {sname!r}: connect upstreams must "
                            "be maps")
                    dest = str(up.get("destination_name", ""))
                    if not dest:
                        raise ValueError(
                            f"service {sname!r}: connect upstream "
                            "missing destination_name")
                    try:
                        bind = int(up.get("local_bind_port", 0))
                    except (TypeError, ValueError):
                        bind = 0
                    if bind <= 0:
                        raise ValueError(
                            f"service {sname!r}: upstream {dest!r} "
                            "needs a positive local_bind_port")
                    if bind in binds:
                        raise ValueError(
                            f"group {tg.name!r}: duplicate connect "
                            f"local_bind_port {bind}")
                    binds.add(bind)
        return []


DEFAULT_ADMISSION_HOOKS = (ImplicitIdentityHook, VaultHook,
                           WorkloadVarScopeHook, ConnectHook)


class AdmissionPipeline:
    """(reference admission.py:252; upstream: job_endpoint.go
    admissionControllers: all mutators, then all validators)."""

    def __init__(self, server, hooks=DEFAULT_ADMISSION_HOOKS):
        self.server = server
        self.hooks = [cls() for cls in hooks]

    def apply(self, job: Job) -> Tuple[Job, List[str]]:
        warnings: List[str] = []
        for hook in self.hooks:
            job, warns = hook.mutate(job)
            warnings.extend(warns)
        for hook in self.hooks:
            warnings.extend(hook.validate(job, self.server))
        return job, warnings
