"""The ACL policy language: named HCL documents that grant capabilities
(port of nomad_tpu/acl/policy.py; upstream: acl/policy.go Parse,
expandNamespacePolicy, expandVariablesCapabilities). A document:

    namespace "default" { policy = "write" }
    namespace "ops-*"   { capabilities = ["list-jobs", "read-job"] }
    namespace "apps" {
      variables { path "nomad/jobs/*" { capabilities = ["read"] } }
    }
    node     { policy = "read" }
    agent    { policy = "write" }
    operator { policy = "read" }
    quota    { policy = "read" }
    plugin   { policy = "list" }
    host_volume "prod-*" { policy = "write" }

A namespace's short policy level expands to its capability set, and a
variables path's read / write to list, read (write, destroy), as
upstream expands them. The HCL is read by the port's own jobspec parser.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

from ..jobspec.hcl import Block, HclError, parse_hcl

# policy levels (upstream: acl/policy.go PolicyDeny..PolicyScale)
POLICY_DENY = "deny"
POLICY_READ = "read"
POLICY_WRITE = "write"
POLICY_LIST = "list"
POLICY_SCALE = "scale"

# namespace capabilities (upstream: acl/policy.go NamespaceCapability*)
CAP_DENY = "deny"
CAP_LIST_JOBS = "list-jobs"
CAP_PARSE_JOB = "parse-job"
CAP_READ_JOB = "read-job"
CAP_SUBMIT_JOB = "submit-job"
CAP_DISPATCH_JOB = "dispatch-job"
CAP_READ_LOGS = "read-logs"
CAP_READ_FS = "read-fs"
CAP_ALLOC_EXEC = "alloc-exec"
CAP_ALLOC_LIFECYCLE = "alloc-lifecycle"
CAP_ALLOC_NODE_EXEC = "alloc-node-exec"
CAP_CSI_REGISTER_PLUGIN = "csi-register-plugin"
CAP_CSI_WRITE_VOLUME = "csi-write-volume"
CAP_CSI_READ_VOLUME = "csi-read-volume"
CAP_CSI_LIST_VOLUME = "csi-list-volume"
CAP_CSI_MOUNT_VOLUME = "csi-mount-volume"
CAP_LIST_SCALING_POLICIES = "list-scaling-policies"
CAP_READ_SCALING_POLICY = "read-scaling-policy"
CAP_READ_JOB_SCALING = "read-job-scaling"
CAP_SCALE_JOB = "scale-job"
CAP_VARIABLES_READ = "variables-read"
CAP_VARIABLES_WRITE = "variables-write"
CAP_VARIABLES_LIST = "variables-list"
CAP_VARIABLES_DESTROY = "variables-destroy"

_READ_CAPS = [
    CAP_LIST_JOBS, CAP_PARSE_JOB, CAP_READ_JOB, CAP_CSI_LIST_VOLUME,
    CAP_CSI_READ_VOLUME, CAP_READ_JOB_SCALING, CAP_LIST_SCALING_POLICIES,
    CAP_READ_SCALING_POLICY, CAP_VARIABLES_READ, CAP_VARIABLES_LIST,
]
_WRITE_CAPS = _READ_CAPS + [
    CAP_SUBMIT_JOB, CAP_DISPATCH_JOB, CAP_READ_LOGS, CAP_READ_FS,
    CAP_ALLOC_EXEC, CAP_ALLOC_LIFECYCLE, CAP_CSI_WRITE_VOLUME,
    CAP_CSI_MOUNT_VOLUME, CAP_SCALE_JOB, CAP_VARIABLES_WRITE,
    CAP_VARIABLES_DESTROY,
]
_SCALE_CAPS = [CAP_LIST_SCALING_POLICIES, CAP_READ_SCALING_POLICY,
               CAP_READ_JOB_SCALING, CAP_SCALE_JOB]


def expand_namespace_policy(level: str) -> List[str]:
    """(upstream: acl/policy.go expandNamespacePolicy)"""
    if level == POLICY_DENY:
        return [CAP_DENY]
    if level == POLICY_READ:
        return list(_READ_CAPS)
    if level == POLICY_WRITE:
        return list(_WRITE_CAPS)
    if level == POLICY_SCALE:
        return list(_SCALE_CAPS)
    raise ValueError(f"invalid namespace policy level: {level!r}")


@dataclass
class NamespaceRule:
    name: str                      # may hold the glob '*'
    policy: str = ""
    capabilities: List[str] = field(default_factory=list)
    variables: List["VariablePathRule"] = field(default_factory=list)

    def all_capabilities(self) -> List[str]:
        caps: List[str] = []
        if self.policy:
            caps.extend(expand_namespace_policy(self.policy))
        caps.extend(self.capabilities)
        return caps


def expand_variables_capabilities(caps: List[str]) -> List[str]:
    """write -> list, read, write, destroy; read -> list, read; deny
    alone wins (upstream: acl/policy.go expandVariablesCapabilities).
    First occurrences kept, in order."""
    if "deny" in caps:
        return ["deny"]
    out: List[str] = []
    for cap in caps:
        if cap == "write":
            out.extend(("list", "read", "write", "destroy"))
        elif cap == "read":
            out.extend(("list", "read"))
        else:
            out.append(cap)
    seen: set = set()
    return [c for c in out if not (c in seen or seen.add(c))]


@dataclass
class VariablePathRule:
    """``variables { path "nomad/jobs/*" { capabilities = [...] } }``"""
    path: str
    capabilities: List[str] = field(default_factory=list)


@dataclass
class HostVolumeRule:
    name: str
    policy: str = ""
    capabilities: List[str] = field(default_factory=list)


@dataclass
class Policy:
    """A parsed, named policy document (upstream: acl/policy.go
    Policy)."""
    name: str = ""
    description: str = ""
    raw: str = ""
    namespaces: List[NamespaceRule] = field(default_factory=list)
    host_volumes: List[HostVolumeRule] = field(default_factory=list)
    node: str = ""
    agent: str = ""
    operator: str = ""
    quota: str = ""
    plugin: str = ""


_COARSE_LEVELS = {POLICY_DENY, POLICY_READ, POLICY_WRITE}
_PLUGIN_LEVELS = {POLICY_DENY, POLICY_LIST, POLICY_READ}


def parse_policy(name: str, src: str) -> Policy:
    """Parse an HCL policy document (upstream: acl/policy.go Parse).
    Raises HclError for bad HCL or a bad coarse level, ValueError for a
    bad namespace level."""
    root = parse_hcl(src)
    pol = Policy(name=name, raw=src)
    for item in root.body:
        if not isinstance(item, Block):
            continue
        if item.type == "namespace":
            attrs = item.attrs()
            rule = NamespaceRule(
                name=item.label(default="default"),
                policy=attrs.get("policy", ""),
                capabilities=list(attrs.get("capabilities", []) or []))
            if rule.policy:
                expand_namespace_policy(rule.policy)  # validates
            for sub in item.blocks("variables"):
                for pb in sub.blocks("path"):
                    rule.variables.append(VariablePathRule(
                        path=pb.label(default="*"),
                        capabilities=expand_variables_capabilities(
                            list(pb.attrs().get("capabilities", []) or []))))
            pol.namespaces.append(rule)
        elif item.type == "host_volume":
            attrs = item.attrs()
            pol.host_volumes.append(HostVolumeRule(
                name=item.label(default="*"),
                policy=attrs.get("policy", ""),
                capabilities=list(attrs.get("capabilities", []) or [])))
        elif item.type in ("node", "agent", "operator", "quota", "plugin"):
            level = item.attrs().get("policy", "")
            allowed = (_PLUGIN_LEVELS if item.type == "plugin"
                       else _COARSE_LEVELS)
            if level and level not in allowed:
                raise HclError(
                    f"invalid {item.type} policy level {level!r}", item.line)
            setattr(pol, item.type, level)
    return pol
