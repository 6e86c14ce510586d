"""Feasibility checks over one node (port of the checkers of
nomad_tpu/scheduler/feasible.py; upstream: scheduler/feasible.go):
check_constraint (:833) with its operand set, ConstraintChecker (:760),
DriverChecker (:476), DeviceChecker (:1270), HostVolumeChecker (:148)
and NetworkChecker (:379). tensor/pack.py pack_feasibility runs them
once per computed node class; the iterators come with the scheduler
slice.
"""
from __future__ import annotations

import operator
import re
from typing import Dict, List, Optional, Set

from ..structs import (
    Constraint, Node, TaskGroup,
    CONSTRAINT_ATTR_IS_NOT_SET, CONSTRAINT_ATTR_IS_SET,
    CONSTRAINT_DISTINCT_HOSTS, CONSTRAINT_DISTINCT_PROPERTY,
    CONSTRAINT_REGEX, CONSTRAINT_SEMVER, CONSTRAINT_SET_CONTAINS,
    CONSTRAINT_SET_CONTAINS_ALL, CONSTRAINT_SET_CONTAINS_ANY,
    CONSTRAINT_VERSION,
)
from .context import EvalContext
from .util import resolve_target

FILTER_CONSTRAINT_HOST_VOLUMES = "missing compatible host volumes"
FILTER_CONSTRAINT_DRIVERS = "missing drivers"
FILTER_CONSTRAINT_DEVICES = "missing devices"


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
