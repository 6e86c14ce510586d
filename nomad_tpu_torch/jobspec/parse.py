"""Jobspec mapping: HCL tree -> Job structs (port of
nomad_tpu/jobspec/parse.py; upstream: jobspec2/parse.go Parse, with the
block and attribute names of jobspec/parse_job.go, parse_group.go,
parse_task.go and parse_network.go: group, task, resources, network,
port, constraint, affinity, spread, update, restart, reschedule, migrate,
periodic, parameterized, meta, env, service, volume, ephemeral_disk,
lifecycle, artifact, template, logs and device). Durations take go-style
strings ("30s", "5m", "1h30m").
"""
from __future__ import annotations

import re
from typing import Any, Dict, Optional

from ..structs import (
    Affinity, Constraint, DeviceRequest, EphemeralDisk, Job, LogConfig,
    MigrateStrategy, NetworkResource, ParameterizedJobConfig,
    PeriodicConfig, Port, ReschedulePolicy, Resources, RestartPolicy,
    Service, Spread, SpreadTarget, Task, TaskGroup, UpdateStrategy,
    VolumeRequest,
)
from .hcl import Block, HclError, parse_hcl

_DUR_RE = re.compile(r"(\d+(?:\.\d+)?)(ms|s|m|h|d)")
_DUR_MULT = {"ms": 0.001, "s": 1.0, "m": 60.0, "h": 3600.0, "d": 86400.0}


def duration(val: Any, default: float = 0.0) -> float:
    """go-style duration -> seconds."""
    if val is None:
        return default
    if isinstance(val, (int, float)):
        return float(val)
    s = str(val).strip()
    if not s:
        return default
    total, matched = 0.0, False
    for m in _DUR_RE.finditer(s):
        total += float(m.group(1)) * _DUR_MULT[m.group(2)]
        matched = True
    if not matched:
        try:
            return float(s)
        except ValueError:
            raise HclError(f"bad duration {val!r}")
    return total


def parse(src: str, variables: Optional[Dict[str, Any]] = None) -> Job:
    """(upstream: jobspec2/parse.go:21 Parse)"""
    root = parse_hcl(src, variables)
    job_block = root.first("job")
    if job_block is None:
        raise HclError("no job block found")
    return parse_job(job_block)


def parse_file(path: str,
               variables: Optional[Dict[str, Any]] = None) -> Job:
    with open(path, encoding="utf-8") as fh:
        return parse(fh.read(), variables)


# ---------------------------------------------------------------------------
def parse_job(b: Block) -> Job:
    a = b.attrs()
    job = Job(
        id=b.label(0) or str(a.get("id", "")),
        name=str(a.get("name", b.label(0))),
        namespace=str(a.get("namespace", "default")),
        region=str(a.get("region", "global")),
        type=str(a.get("type", "service")),
        priority=int(a.get("priority", 50)),
        all_at_once=bool(a.get("all_at_once", False)),
        datacenters=[str(d) for d in a.get("datacenters", ["*"])],
        node_pool=str(a.get("node_pool", "default")),
        vault_namespace=str(a.get("vault_namespace", "")),
    )
    job.meta = {str(k): str(v) for k, v in _meta(b).items()}
    job.constraints = [_constraint(c) for c in b.blocks("constraint")]
    job.affinities = [_affinity(c) for c in b.blocks("affinity")]
    job.spreads = [_spread(s) for s in b.blocks("spread")]
    upd = b.first("update")
    if upd is not None:
        job.update = _update(upd)
    per = b.first("periodic")
    if per is not None:
        pa = per.attrs()
        job.periodic = PeriodicConfig(
            enabled=bool(pa.get("enabled", True)),
            spec=str(pa.get("cron", pa.get("spec", ""))),
            prohibit_overlap=bool(pa.get("prohibit_overlap", False)),
            timezone=str(pa.get("time_zone", "UTC")))
    param = b.first("parameterized")
    if param is not None:
        pa = param.attrs()
        job.parameterized = ParameterizedJobConfig(
            payload=str(pa.get("payload", "optional")),
            meta_required=[str(x) for x in pa.get("meta_required", [])],
            meta_optional=[str(x) for x in pa.get("meta_optional", [])])
    for g in b.blocks("group"):
        job.task_groups.append(parse_group(g, job))
    if not job.task_groups:
        # single top-level task sugar (upstream: jobspec allows task at
        # job level wrapped into an implicit group)
        tasks = b.blocks("task")
        if tasks:
            tg = TaskGroup(name=job.id, count=1,
                           tasks=[parse_task(t) for t in tasks])
            job.task_groups.append(tg)
    return job


def parse_group(b: Block, job: Job) -> TaskGroup:
    a = b.attrs()
    tg = TaskGroup(
        name=b.label(0),
        count=int(a.get("count", 1)),
        meta={str(k): str(v) for k, v in _meta(b).items()},
    )
    if "max_client_disconnect" in a:
        tg.max_client_disconnect_s = duration(a["max_client_disconnect"])
    if "stop_after_client_disconnect" in a:
        tg.stop_after_client_disconnect_s = duration(
            a["stop_after_client_disconnect"])
    tg.prevent_reschedule_on_lost = bool(
        a.get("prevent_reschedule_on_lost", False))
    tg.constraints = [_constraint(c) for c in b.blocks("constraint")]
    tg.affinities = [_affinity(c) for c in b.blocks("affinity")]
    tg.spreads = [_spread(s) for s in b.blocks("spread")]
    sc = b.first("scaling")
    if sc is not None:
        sa = sc.attrs()
        tg.scaling = {
            "min": int(sa.get("min", 0)),
            "max": int(sa.get("max", tg.count)),
            "enabled": bool(sa.get("enabled", True)),
            "policy": {blk.label(0) or "policy": blk.attrs()
                       for blk in sc.blocks("policy")},
        }
    tg.networks = [_network(n) for n in b.blocks("network")]
    tg.services = [_service(s) for s in b.blocks("service")]
    upd = b.first("update")
    if upd is not None:
        tg.update = _update(upd)
    res = b.first("restart")
    if res is not None:
        ra = res.attrs()
        tg.restart_policy = RestartPolicy(
            attempts=int(ra.get("attempts", 2)),
            interval_s=duration(ra.get("interval"), 1800.0),
            delay_s=duration(ra.get("delay"), 15.0),
            mode=str(ra.get("mode", "fail")))
    rs = b.first("reschedule")
    if rs is not None:
        ra = rs.attrs()
        tg.reschedule_policy = ReschedulePolicy(
            attempts=int(ra.get("attempts", 0)),
            interval_s=duration(ra.get("interval"), 0.0),
            delay_s=duration(ra.get("delay"), 30.0),
            delay_function=str(ra.get("delay_function", "exponential")),
            max_delay_s=duration(ra.get("max_delay"), 3600.0),
            unlimited=bool(ra.get("unlimited", True)))
    mig = b.first("migrate")
    if mig is not None:
        ma = mig.attrs()
        tg.migrate = MigrateStrategy(
            max_parallel=int(ma.get("max_parallel", 1)),
            health_check=str(ma.get("health_check", "checks")),
            min_healthy_time_s=duration(ma.get("min_healthy_time"), 10.0),
            healthy_deadline_s=duration(ma.get("healthy_deadline"), 300.0))
    eph = b.first("ephemeral_disk")
    if eph is not None:
        ea = eph.attrs()
        tg.ephemeral_disk = EphemeralDisk(
            sticky=bool(ea.get("sticky", False)),
            size_mb=int(ea.get("size", 300)),
            migrate=bool(ea.get("migrate", False)))
    for v in b.blocks("volume"):
        va = v.attrs()
        tg.volumes[v.label(0)] = VolumeRequest(
            name=v.label(0), type=str(va.get("type", "host")),
            source=str(va.get("source", "")),
            read_only=bool(va.get("read_only", False)),
            access_mode=str(va.get("access_mode", "")),
            attachment_mode=str(va.get("attachment_mode", "")),
            per_alloc=bool(va.get("per_alloc", False)))
    for t in b.blocks("task"):
        tg.tasks.append(parse_task(t))
    return tg


def parse_task(b: Block) -> Task:
    a = b.attrs()
    task = Task(
        name=b.label(0),
        driver=str(a.get("driver", "mock")),
        user=str(a.get("user", "")),
        leader=bool(a.get("leader", False)),
        kind=str(a.get("kind", "")),
        kill_timeout_s=duration(a.get("kill_timeout"), 5.0),
        meta={str(k): str(v) for k, v in _meta(b).items()},
    )
    cfg = b.first("config")
    if cfg is not None:
        task.config = _config_tree(cfg)
    envb = b.first("env")
    if envb is not None:
        task.env = {str(k): str(v) for k, v in envb.attrs().items()}
    task.constraints = [_constraint(c) for c in b.blocks("constraint")]
    task.affinities = [_affinity(c) for c in b.blocks("affinity")]
    task.services = [_service(s) for s in b.blocks("service")]
    res = b.first("resources")
    if res is not None:
        task.resources = _resources(res)
    lc = b.first("lifecycle")
    if lc is not None:
        la = lc.attrs()
        task.lifecycle = {"hook": str(la.get("hook", "")),
                          "sidecar": bool(la.get("sidecar", False))}
    logs = b.first("logs")
    if logs is not None:
        la = logs.attrs()
        task.log_config = LogConfig(
            max_files=int(la.get("max_files", 10)),
            max_file_size_mb=int(la.get("max_file_size", 10)))
    for art in b.blocks("artifact"):
        aa = art.attrs()
        task.artifacts.append({
            "source": str(aa.get("source", "")),
            "destination": str(aa.get("destination", "")),
            "mode": str(aa.get("mode", "any"))})
    for tpl in b.blocks("template"):
        ta = tpl.attrs()
        task.templates.append({
            "data": str(ta.get("data", "")),
            "source": str(ta.get("source", "")),
            "destination": str(ta.get("destination", "")),
            "change_mode": str(ta.get("change_mode", "restart"))})
    vault = b.first("vault")
    if vault is not None:
        task.vault = vault.attrs()
    return task


# ---------------------------------------------------------------------------
def _meta(b: Block) -> Dict[str, Any]:
    m = b.first("meta")
    return m.attrs() if m is not None else {}


def _config_tree(b: Block) -> Dict[str, Any]:
    """config blocks may nest sub-blocks (e.g. docker mounts)."""
    out: Dict[str, Any] = dict(b.attrs())
    for sub in b.blocks():
        out.setdefault(sub.type, []).append(_config_tree(sub))
    return out


def _constraint(b: Block) -> Constraint:
    a = b.attrs()
    operand = str(a.get("operator", a.get("operand", "=")))
    # sugar forms (upstream: parse_job.go constraint shorthands)
    for sugar in ("distinct_hosts", "distinct_property", "regexp",
                  "version", "semver", "set_contains", "is_set",
                  "is_not_set"):
        if sugar in a:
            operand = sugar
            if sugar not in ("distinct_hosts", "is_set", "is_not_set"):
                a.setdefault("value", a[sugar])
            break
    return Constraint(
        l_target=str(a.get("attribute", "")),
        r_target=str(a.get("value", "")),
        operand=operand)


def _affinity(b: Block) -> Affinity:
    a = b.attrs()
    return Affinity(
        l_target=str(a.get("attribute", "")),
        r_target=str(a.get("value", "")),
        operand=str(a.get("operator", a.get("operand", "="))),
        weight=int(a.get("weight", 50)))


def _spread(b: Block) -> Spread:
    a = b.attrs()
    targets = []
    for t in b.blocks("target"):
        ta = t.attrs()
        targets.append(SpreadTarget(
            value=t.label(0) or str(ta.get("value", "")),
            percent=int(ta.get("percent", 0))))
    return Spread(attribute=str(a.get("attribute", "")),
                  weight=int(a.get("weight", 50)),
                  spread_target=targets)


def _update(b: Block) -> UpdateStrategy:
    a = b.attrs()
    return UpdateStrategy(
        stagger_s=duration(a.get("stagger"), 30.0),
        max_parallel=int(a.get("max_parallel", 1)),
        health_check=str(a.get("health_check", "checks")),
        min_healthy_time_s=duration(a.get("min_healthy_time"), 10.0),
        healthy_deadline_s=duration(a.get("healthy_deadline"), 300.0),
        progress_deadline_s=duration(a.get("progress_deadline"), 600.0),
        auto_revert=bool(a.get("auto_revert", False)),
        auto_promote=bool(a.get("auto_promote", False)),
        canary=int(a.get("canary", 0)))


def _network(b: Block) -> NetworkResource:
    a = b.attrs()
    net = NetworkResource(mode=str(a.get("mode", "host")),
                          mbits=int(a.get("mbits", 0)))
    for p in b.blocks("port"):
        pa = p.attrs()
        port = Port(label=p.label(0),
                    value=int(pa.get("static", 0)),
                    to=int(pa.get("to", 0)),
                    host_network=str(pa.get("host_network", "default")))
        if port.value:
            net.reserved_ports.append(port)
        else:
            net.dynamic_ports.append(port)
    return net


def _service(b: Block) -> Service:
    a = b.attrs()
    connect = None
    cb = b.first("connect")
    if cb is not None:
        sb = cb.first("sidecar_service")
        if sb is not None:
            proxy = {}
            pb = sb.first("proxy")
            if pb is not None:
                proxy["upstreams"] = [{
                    "destination_name":
                        str(u.attrs().get("destination_name", "")),
                    "local_bind_port":
                        int(u.attrs().get("local_bind_port", 0)),
                } for u in pb.blocks("upstreams")]
            connect = {"sidecar_service": {"proxy": proxy} if proxy
                       else {}}
    return Service(
        name=str(a.get("name", b.label(0))),
        port_label=str(a.get("port", "")),
        provider=str(a.get("provider", "consul")),
        tags=[str(t) for t in a.get("tags", [])],
        checks=[c.attrs() for c in b.blocks("check")],
        connect=connect)


def _resources(b: Block) -> Resources:
    a = b.attrs()
    res = Resources(
        cpu=int(a.get("cpu", 100)),
        cores=int(a.get("cores", 0)),
        memory_mb=int(a.get("memory", 300)),
        memory_max_mb=int(a.get("memory_max", 0)),
        disk_mb=int(a.get("disk", 0)))
    for n in b.blocks("network"):
        res.networks.append(_network(n))
    for d in b.blocks("device"):
        da = d.attrs()
        res.devices.append(DeviceRequest(
            name=d.label(0), count=int(da.get("count", 1)),
            constraints=[_constraint(c) for c in d.blocks("constraint")],
            affinities=[_affinity(c) for c in d.blocks("affinity")]))
    return res
