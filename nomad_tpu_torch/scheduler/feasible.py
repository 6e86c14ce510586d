"""Feasibility checks and iterators (port of nomad_tpu/scheduler/
feasible.py; upstream: scheduler/feasible.go): check_constraint (:833)
with its operand set, ConstraintChecker (:760), DriverChecker (:476),
DeviceChecker (:1270), HostVolumeChecker (:148), CSIVolumeChecker
(:230) and NetworkChecker (:379); the iterators StaticIterator (:60),
FeasibilityWrapper with computed-class memoization (:1126),
DistinctHostsIterator (:555) and DistinctPropertyIterator (:661).
tensor/pack.py pack_feasibility runs the checkers once per computed node
class; the placement stacks (stack.py) chain the iterators.
"""
from __future__ import annotations

import operator
import re
from typing import Dict, List, Optional, Set

from ..structs import (
    Constraint, Job, Node, TaskGroup,
    CONSTRAINT_ATTR_IS_NOT_SET, CONSTRAINT_ATTR_IS_SET,
    CONSTRAINT_DISTINCT_HOSTS, CONSTRAINT_DISTINCT_PROPERTY,
    CONSTRAINT_REGEX, CONSTRAINT_SEMVER, CONSTRAINT_SET_CONTAINS,
    CONSTRAINT_SET_CONTAINS_ALL, CONSTRAINT_SET_CONTAINS_ANY,
    CONSTRAINT_VERSION,
)
from .context import (
    ELIGIBILITY_ESCAPED, ELIGIBILITY_INELIGIBLE, ELIGIBILITY_UNKNOWN,
    EvalContext,
)
from .util import resolve_target

FILTER_CONSTRAINT_HOST_VOLUMES = "missing compatible host volumes"
FILTER_CONSTRAINT_DRIVERS = "missing drivers"
FILTER_CONSTRAINT_DEVICES = "missing devices"
FILTER_CONSTRAINT_CSI_VOLUMES = \
    "CSI volume has exhausted its available writer claims"
FILTER_CONSTRAINT_CSI_PLUGINS = "CSI plugin is missing or unhealthy"


class FeasibleIterator:
    """Iterator protocol: next() -> Node | None, reset()."""

    def next(self) -> Optional[Node]:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError


class StaticIterator(FeasibleIterator):
    """Returns nodes in a fixed order (upstream: feasible.go:60)."""

    def __init__(self, ctx: EvalContext, nodes: List[Node]):
        self.ctx = ctx
        self.nodes = list(nodes)
        self.offset = 0
        self.seen = 0

    def next(self) -> Optional[Node]:
        if self.offset == len(self.nodes) or self.seen == len(self.nodes):
            return None
        n = self.nodes[self.offset]
        self.offset += 1
        self.seen += 1
        self.ctx.metrics.nodes_evaluated += 1
        return n

    def reset(self) -> None:
        self.offset = 0
        self.seen = 0

    def set_nodes(self, nodes: List[Node]) -> None:
        self.nodes = list(nodes)
        self.offset = 0
        self.seen = 0


def new_random_iterator(ctx: EvalContext, nodes: List[Node]) -> StaticIterator:
    """A StaticIterator over shuffled nodes (upstream: feasible.go:129
    NewRandomIterator); GenericStack.set_nodes shuffles, seeded by the
    eval id."""
    return StaticIterator(ctx, nodes)


# ---------------------------------------------------------------------------
# Constraint checking primitives
# ---------------------------------------------------------------------------

_ORDER_OPS = {"<": operator.lt, "<=": operator.le,
              ">": operator.gt, ">=": operator.ge}


def _check_order(op: str, lval, rval) -> bool:
    """Numeric if both parse as ints, then floats, else lexical
    (reference: feasible.go checkOrder)."""
    l, r = str(lval), str(rval)
    for conv in (int, float):
        try:
            return _ORDER_OPS[op](conv(l), conv(r))
        except (ValueError, TypeError):
            continue
    return _ORDER_OPS[op](l, r)


def parse_version(v: str) -> Optional[tuple]:
    """Parse '1.2.3-beta.1+meta' into a comparable tuple.
    Prerelease versions sort before releases (semver rule)."""
    v = str(v).strip().lstrip("v")
    v = v.split("+", 1)[0]
    if "-" in v:
        core, pre = v.split("-", 1)
    else:
        core, pre = v, None
    try:
        nums = tuple(int(x) for x in core.split("."))
    except ValueError:
        return None
    while len(nums) < 3:
        nums = nums + (0,)
    # (release=1) > (prerelease=0); prerelease idents compare component-wise
    if pre is None:
        return nums + ((1,),)
    pre_ids = tuple((0, int(p)) if p.isdigit() else (1, p)
                    for p in pre.split("."))
    return nums + ((0, pre_ids),)


_VER_CONSTRAINT_RE = re.compile(r"^\s*(>=|<=|!=|>|<|=|~>)?\s*(.+?)\s*$")


def check_version_constraint(lval, constraint_expr: str,
                             allow_prerelease: bool = True) -> bool:
    """Evaluate 'version' / 'semver' constraints like '>= 1.2, < 2.0'
    (reference: feasible.go checkVersionMatch with go-version semantics;
    'semver' is strict -- prereleases never satisfy range constraints)."""
    actual = parse_version(str(lval))
    if actual is None:
        return False
    is_prerelease = actual[3][0] == 0
    for part in str(constraint_expr).split(","):
        m = _VER_CONSTRAINT_RE.match(part)
        if not m:
            return False
        op = m.group(1) or "="
        want = parse_version(m.group(2))
        if want is None:
            return False
        if not allow_prerelease and is_prerelease and op != "=":
            return False
        if op == "=":
            ok = actual == want
        elif op == "!=":
            ok = actual != want
        elif op == "~>":   # pessimistic: >= want, < next significant
            raw = m.group(2).lstrip("v").split("-")[0]
            n = len(raw.split("."))
            bump = list(want[:3])
            if n <= 1:
                bump = [bump[0] + 1, 0, 0]
            elif n == 2:
                bump = [bump[0] + 1, 0, 0]
            else:
                bump = [bump[0], bump[1] + 1, 0]
            ok = actual >= want and actual[:3] < tuple(bump)
        else:
            ok = _ORDER_OPS[op](actual, want)
        if not ok:
            return False
    return True


def check_set_contains_all(lval, rval) -> bool:
    have = {p.strip() for p in str(lval).split(",")}
    want = [p.strip() for p in str(rval).split(",")]
    return all(w in have for w in want)


def check_set_contains_any(lval, rval) -> bool:
    have = {p.strip() for p in str(lval).split(",")}
    want = [p.strip() for p in str(rval).split(",")]
    return any(w in have for w in want)


def check_constraint(ctx: EvalContext, operand: str, lval, rval,
                     l_found: bool, r_found: bool) -> bool:
    """The full operand dispatch (reference: feasible.go:833 checkConstraint)."""
    if operand in (CONSTRAINT_DISTINCT_HOSTS, CONSTRAINT_DISTINCT_PROPERTY):
        return True  # handled by dedicated iterators
    if operand in ("=", "==", "is"):
        return l_found and r_found and str(lval) == str(rval)
    if operand in ("!=", "not"):
        return str(lval) != str(rval)
    if operand in _ORDER_OPS:
        return l_found and r_found and _check_order(operand, lval, rval)
    if operand == CONSTRAINT_ATTR_IS_SET:
        return l_found
    if operand == CONSTRAINT_ATTR_IS_NOT_SET:
        return not l_found
    if operand == CONSTRAINT_VERSION:
        return l_found and r_found and check_version_constraint(
            lval, rval, allow_prerelease=True)
    if operand == CONSTRAINT_SEMVER:
        return l_found and r_found and check_version_constraint(
            lval, rval, allow_prerelease=False)
    if operand == CONSTRAINT_REGEX:
        if not (l_found and r_found):
            return False
        pat = ctx.regex(str(rval))
        return pat is not None and pat.search(str(lval)) is not None
    if operand in (CONSTRAINT_SET_CONTAINS, CONSTRAINT_SET_CONTAINS_ALL):
        return l_found and r_found and check_set_contains_all(lval, rval)
    if operand == CONSTRAINT_SET_CONTAINS_ANY:
        return l_found and r_found and check_set_contains_any(lval, rval)
    return False


def nodes_meet_constraint(ctx: EvalContext, node: Node,
                          constraint: Constraint) -> bool:
    lval, l_ok = resolve_target(constraint.l_target, node)
    rval, r_ok = resolve_target(constraint.r_target, node)
    return check_constraint(ctx, constraint.operand, lval, rval, l_ok, r_ok)


# ---------------------------------------------------------------------------
# Checkers (single-node predicates used inside the FeasibilityWrapper)
# ---------------------------------------------------------------------------

class ConstraintChecker:
    """(reference: feasible.go:760)"""

    def __init__(self, ctx: EvalContext, constraints: List[Constraint]):
        self.ctx = ctx
        self.constraints = constraints or []

    def set_constraints(self, constraints: List[Constraint]) -> None:
        self.constraints = constraints or []

    def feasible(self, node: Node) -> bool:
        for c in self.constraints:
            if not nodes_meet_constraint(self.ctx, node, c):
                self.ctx.metrics.filter_node(node.computed_class, str(c))
                return False
        return True


class DriverChecker:
    """(reference: feasible.go:476)"""

    def __init__(self, ctx: EvalContext, drivers: Set[str]):
        self.ctx = ctx
        self.drivers = drivers or set()

    def set_drivers(self, drivers: Set[str]) -> None:
        self.drivers = drivers

    def feasible(self, node: Node) -> bool:
        for driver in self.drivers:
            info = node.drivers.get(driver)
            if info is not None:
                if not (info.detected and info.healthy):
                    self.ctx.metrics.filter_node(
                        node.computed_class, FILTER_CONSTRAINT_DRIVERS)
                    return False
                continue
            # fall back to fingerprint attribute driver.<name> in {1,true}
            raw = node.attributes.get(f"driver.{driver}", "")
            if str(raw).lower() not in ("1", "true"):
                self.ctx.metrics.filter_node(
                    node.computed_class, FILTER_CONSTRAINT_DRIVERS)
                return False
        return True


class DeviceChecker:
    """Do the node's device groups cover the TG's device asks, constraints
    included? (reference: feasible.go:1270)"""

    def __init__(self, ctx: EvalContext):
        self.ctx = ctx
        self.required: list = []

    def set_task_group(self, tg: TaskGroup) -> None:
        self.required = []
        for task in tg.tasks:
            self.required.extend(task.resources.devices)

    def feasible(self, node: Node) -> bool:
        if not self.required:
            return True
        for req in self.required:
            if not self._has_device(node, req):
                self.ctx.metrics.filter_node(
                    node.computed_class, FILTER_CONSTRAINT_DEVICES)
                return False
        return True

    def _has_device(self, node: Node, req) -> bool:
        for group in node.node_resources.devices:
            if not group.matches_request(req.name):
                continue
            if len(group.instance_ids) < req.count:
                continue
            if req.constraints and not self._check_device_constraints(
                    group, req.constraints):
                continue
            return True
        return False

    def _check_device_constraints(self, group, constraints) -> bool:
        for c in constraints:
            lval, l_ok = self._resolve_device_target(c.l_target, group)
            rval, r_ok = self._resolve_device_target(c.r_target, group)
            if not check_constraint(self.ctx, c.operand, lval, rval, l_ok, r_ok):
                return False
        return True

    @staticmethod
    def _resolve_device_target(target: str, group):
        if not target.startswith("${"):
            return target, True
        inner = target[2:-1]
        if inner.startswith("device.attr."):
            key = inner[len("device.attr."):]
            if key in group.attributes:
                return group.attributes[key], True
            return "", False
        if inner == "device.model":
            return group.name, True
        if inner == "device.vendor":
            return group.vendor, True
        if inner == "device.type":
            return group.type, True
        return "", False


class HostVolumeChecker:
    """(reference: feasible.go:148)"""

    def __init__(self, ctx: EvalContext):
        self.ctx = ctx
        self.volumes: Dict[str, object] = {}

    def set_volumes(self, alloc_name: str, volumes: Dict[str, object]) -> None:
        self.volumes = {}
        for name, req in (volumes or {}).items():
            if req.type != "host":
                continue
            self.volumes[name] = (req.source_for(alloc_name), req.read_only)

    def feasible(self, node: Node) -> bool:
        for name, (source, read_only) in self.volumes.items():
            cfg = node.host_volumes.get(source)
            if cfg is None:
                self.ctx.metrics.filter_node(
                    node.computed_class, FILTER_CONSTRAINT_HOST_VOLUMES)
                return False
            if cfg.read_only and not read_only:
                self.ctx.metrics.filter_node(
                    node.computed_class, FILTER_CONSTRAINT_HOST_VOLUMES)
                return False
        return True


def plugin_healthy(info) -> bool:
    """A node's csi_node_plugins entry (a dict, or an object with
    ``healthy``) reads as healthy; None means the plugin is absent."""
    if info is None:
        return False
    if isinstance(info, dict):
        return bool(info.get("healthy", True))
    return bool(getattr(info, "healthy", True))


class CSIVolumeChecker:
    """The volume exists, is schedulable and claimable, and the node runs
    a healthy instance of its plugin (upstream: feasible.go:230). A
    state without CSI volumes filters every node that asks for one."""

    def __init__(self, ctx: EvalContext):
        self.ctx = ctx
        self.namespace = "default"
        self.volumes: Dict[str, object] = {}

    def set_namespace(self, namespace: str) -> None:
        self.namespace = namespace

    def set_volumes(self, alloc_name: str, volumes: Dict[str, object]) -> None:
        self.volumes = {}
        for name, req in (volumes or {}).items():
            if req.type != "csi":
                continue
            self.volumes[name] = (req.source_for(alloc_name), req.read_only)

    def feasible(self, node: Node) -> bool:
        if not self.volumes:
            return True
        snap = self.ctx.state
        for name, (source, read_only) in self.volumes.items():
            vol = (snap.csi_volume_by_id(self.namespace, source)
                   if hasattr(snap, "csi_volume_by_id") else None)
            if vol is None or not vol.schedulable:
                self.ctx.metrics.filter_node(
                    node.computed_class, FILTER_CONSTRAINT_CSI_VOLUMES)
                return False
            mode = "read" if read_only else "write"
            # claims held by this node's allocs do not block placing
            # onto the same node again
            if not vol.claim_ok(mode):
                holders = set(c.node_id for c in vol.write_claims.values())
                holders |= set(c.node_id for c in vol.read_claims.values())
                if holders != {node.id}:
                    self.ctx.metrics.filter_node(
                        node.computed_class, FILTER_CONSTRAINT_CSI_VOLUMES)
                    return False
            if not plugin_healthy(
                    (node.csi_node_plugins or {}).get(vol.plugin_id)):
                self.ctx.metrics.filter_node(
                    node.computed_class, FILTER_CONSTRAINT_CSI_PLUGINS)
                return False
        return True


class NetworkChecker:
    """Does the node expose the asked host networks / network mode?
    (reference: feasible.go:379)"""

    def __init__(self, ctx: EvalContext):
        self.ctx = ctx
        self.network = None

    def set_network(self, network) -> None:
        self.network = network

    def feasible(self, node: Node) -> bool:
        if self.network is None:
            return True
        mode = self.network.mode or "host"
        if mode.startswith("cni/"):
            plugin = mode[len("cni/"):]
            if f"plugins.cni.version.{plugin}" not in node.attributes:
                self.ctx.metrics.filter_node(
                    node.computed_class, f"missing network CNI plugin {plugin}")
                return False
            return True
        if mode == "bridge":
            if str(node.attributes.get("nomad.bridge", "true")).lower() == "false":
                self.ctx.metrics.filter_node(
                    node.computed_class, "missing bridge network")
                return False
            return True
        # host networks referenced by ports must exist on the node
        wanted = set()
        for p in list(self.network.reserved_ports) + list(self.network.dynamic_ports):
            if p.host_network and p.host_network != "default":
                wanted.add(p.host_network)
        if wanted:
            have = {n.device for n in node.node_resources.networks}
            missing = wanted - have
            if missing:
                self.ctx.metrics.filter_node(
                    node.computed_class,
                    f"missing host network {sorted(missing)[0]!r} for port")
                return False
        return True


# ---------------------------------------------------------------------------
# Wrapper + distinct iterators
# ---------------------------------------------------------------------------

class FeasibilityWrapper(FeasibleIterator):
    """Runs the job-level then the task-group-level checkers, memoized
    per computed node class, then the availability checkers on every
    node (upstream: feasible.go:1126)."""

    def __init__(self, ctx: EvalContext, source: FeasibleIterator,
                 job_checkers: list, tg_checkers: list,
                 avail_checkers: list):
        self.ctx = ctx
        self.source = source
        self.job_checkers = job_checkers
        self.tg_checkers = tg_checkers
        self.avail_checkers = avail_checkers   # per alloc, never cached
        self.tg_name = ""

    def set_task_group(self, tg_name: str) -> None:
        self.tg_name = tg_name

    def reset(self) -> None:
        self.source.reset()

    def next(self) -> Optional[Node]:
        elig = self.ctx.eligibility()
        while True:
            node = self.source.next()
            if node is None:
                return None
            cls = node.computed_class

            job_status = elig.job_status(cls)
            if job_status == ELIGIBILITY_INELIGIBLE:
                self.ctx.metrics.filter_node(cls, "")
                continue
            if job_status in (ELIGIBILITY_ESCAPED, ELIGIBILITY_UNKNOWN):
                ok = all(c.feasible(node) for c in self.job_checkers)
                if job_status == ELIGIBILITY_UNKNOWN:
                    elig.set_job_eligibility(ok, cls)
                if not ok:
                    continue

            tg_status = elig.task_group_status(self.tg_name, cls)
            if tg_status == ELIGIBILITY_INELIGIBLE:
                self.ctx.metrics.filter_node(cls, "")
                continue
            if tg_status in (ELIGIBILITY_ESCAPED, ELIGIBILITY_UNKNOWN):
                ok = all(c.feasible(node) for c in self.tg_checkers)
                if tg_status == ELIGIBILITY_UNKNOWN:
                    elig.set_task_group_eligibility(ok, self.tg_name, cls)
                if not ok:
                    continue

            if not all(c.feasible(node) for c in self.avail_checkers):
                continue
            return node


class DistinctHostsIterator(FeasibleIterator):
    """Filters the nodes that already hold an alloc of this job (or task
    group) under distinct_hosts (upstream: feasible.go:555)."""

    def __init__(self, ctx: EvalContext, source: FeasibleIterator):
        self.ctx = ctx
        self.source = source
        self.tg = None
        self.job = None
        self.tg_distinct = False
        self.job_distinct = False

    def set_task_group(self, tg: TaskGroup) -> None:
        self.tg = tg
        self.tg_distinct = self._has_distinct(tg.constraints)

    def set_job(self, job: Job) -> None:
        self.job = job
        self.job_distinct = self._has_distinct(job.constraints)

    @staticmethod
    def _has_distinct(constraints) -> bool:
        return any(c.operand == CONSTRAINT_DISTINCT_HOSTS and
                   str(c.r_target).lower() not in ("false",)
                   for c in constraints or [])

    def next(self) -> Optional[Node]:
        while True:
            node = self.source.next()
            if node is None or not (self.tg_distinct or self.job_distinct):
                return node
            if self._satisfies(node):
                return node
            self.ctx.metrics.filter_node(
                node.computed_class, CONSTRAINT_DISTINCT_HOSTS)

    def _satisfies(self, node: Node) -> bool:
        for alloc in self.ctx.proposed_allocs(node.id):
            job_collision = alloc.job_id == self.job.id and \
                alloc.namespace == self.job.namespace
            task_collision = alloc.task_group == self.tg.name
            if self.job_distinct and job_collision:
                return False
            if self.tg_distinct and job_collision and task_collision:
                return False
        return True

    def reset(self) -> None:
        self.source.reset()


class DistinctPropertyIterator(FeasibleIterator):
    """distinct_property: at most r_target (default 1) of the job's (or
    task group's) allocs per value of the attribute, plan placements in,
    plan stops out (upstream: feasible.go:661, propertyset.go)."""

    def __init__(self, ctx: EvalContext, source: FeasibleIterator):
        self.ctx = ctx
        self.source = source
        self.job = None
        self.tg = None
        self.job_property_sets: list = []
        self.tg_property_sets: list = []

    def set_job(self, job: Job) -> None:
        self.job = job
        self.job_property_sets = [
            c for c in job.constraints
            if c.operand == CONSTRAINT_DISTINCT_PROPERTY]

    def set_task_group(self, tg: TaskGroup) -> None:
        self.tg = tg
        self.tg_property_sets = [
            c for c in tg.constraints
            if c.operand == CONSTRAINT_DISTINCT_PROPERTY]

    @staticmethod
    def _count_limit(c: Constraint) -> int:
        try:
            return max(1, int(c.r_target)) if c.r_target else 1
        except ValueError:
            return 1

    def next(self) -> Optional[Node]:
        while True:
            node = self.source.next()
            if node is None:
                return None
            if not self.job_property_sets and not self.tg_property_sets:
                return node
            if self._satisfies(node):
                return node
            self.ctx.metrics.filter_node(
                node.computed_class, CONSTRAINT_DISTINCT_PROPERTY)

    def _satisfies(self, node: Node) -> bool:
        allocs = [a for a in self.ctx.state.allocs_by_job(
            self.job.namespace, self.job.id) if not a.terminal_status()]
        removed = set()
        for na in self.ctx.plan.node_update.values():
            removed.update(a.id for a in na)
        allocs = [a for a in allocs if a.id not in removed]
        for na in self.ctx.plan.node_allocation.values():
            allocs.extend(na)

        for scope, csets in (("job", self.job_property_sets),
                             ("tg", self.tg_property_sets)):
            for c in csets:
                val, ok = resolve_target(c.l_target, node)
                if not ok:
                    return False
                limit = self._count_limit(c)
                used = 0
                for alloc in allocs:
                    if scope == "tg" and alloc.task_group != self.tg.name:
                        continue
                    other = self.ctx.state.node_by_id(alloc.node_id)
                    if other is None:
                        continue
                    oval, ook = resolve_target(c.l_target, other)
                    if ook and str(oval) == str(val):
                        used += 1
                if used >= limit:
                    return False
        return True

    def reset(self) -> None:
        self.source.reset()
