"""Compiled ACLs: policies merged into capability sets that answer the
API's authorization questions (port of nomad_tpu/acl/acl.py; upstream:
acl/acl.go:106 NewACL). Deny wins; a namespace rule is matched by its
exact name first, else by the longest matching glob. Exact rules sit in
a dict and globs in a second one (upstream keeps radix trees: a cluster
has few policies).
"""
from __future__ import annotations

from fnmatch import fnmatchcase
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .policy import (
    CAP_DENY, POLICY_DENY, POLICY_LIST, POLICY_READ, POLICY_WRITE,
    Policy, VariablePathRule,
)

# deny > write > list > read > '' (upstream: acl.go maxPrivilege)
_COARSE_ORDER = {POLICY_DENY: 4, POLICY_WRITE: 3, POLICY_LIST: 2,
                 POLICY_READ: 1, "": 0}


def _merge_coarse(cur: str, new: str) -> str:
    return new if _COARSE_ORDER.get(new, 0) > _COARSE_ORDER.get(cur, 0) \
        else cur


def _closest_glob(name: str, patterns) -> Optional[str]:
    """The glob of ``patterns`` matching ``name`` with the most literal
    characters (ties: the greater pattern), else None (upstream:
    acl.go findClosestMatchingGlob)."""
    best: Optional[Tuple[int, str]] = None
    for pattern in patterns:
        if fnmatchcase(name, pattern):
            key = (len(pattern.replace("*", "")), pattern)
            if best is None or key > best:
                best = key
    return best[1] if best else None


class ACL:
    """An immutable, compiled ACL (upstream: acl/acl.go ACL)."""

    def __init__(self, management: bool = False,
                 policies: Iterable[Policy] = ()):
        self.management = management
        # namespace -> capability set (CAP_DENY sticky)
        self._ns_exact: Dict[str, Set[str]] = {}
        self._ns_glob: Dict[str, Set[str]] = {}
        self._ns_variables: Dict[str, List[VariablePathRule]] = {}
        self._hv_exact: Dict[str, Set[str]] = {}
        self._hv_glob: Dict[str, Set[str]] = {}
        self.node = ""
        self.agent = ""
        self.operator = ""
        self.quota = ""
        self.plugin = ""
        for pol in policies:
            self._merge(pol)

    def _merge(self, pol: Policy) -> None:
        for rule in pol.namespaces:
            table = (self._ns_glob if "*" in rule.name else self._ns_exact)
            caps = table.setdefault(rule.name, set())
            caps.update(rule.all_capabilities())
            if rule.variables:
                self._ns_variables.setdefault(
                    rule.name, []).extend(rule.variables)
        for hv in pol.host_volumes:
            table = (self._hv_glob if "*" in hv.name else self._hv_exact)
            caps = table.setdefault(hv.name, set())
            if hv.policy == POLICY_READ:
                caps.add("mount-readonly")
            elif hv.policy == POLICY_WRITE:
                caps.update(("mount-readonly", "mount-readwrite"))
            elif hv.policy == POLICY_DENY:
                caps.add(CAP_DENY)
            caps.update(hv.capabilities)
        self.node = _merge_coarse(self.node, pol.node)
        self.agent = _merge_coarse(self.agent, pol.agent)
        self.operator = _merge_coarse(self.operator, pol.operator)
        self.quota = _merge_coarse(self.quota, pol.quota)
        self.plugin = _merge_coarse(self.plugin, pol.plugin)

    # -- namespaces -------------------------------------------------------
    def _ns_caps(self, ns: str) -> Optional[Set[str]]:
        """The exact rule's capabilities, else the closest glob's
        (upstream: acl.go AllowNamespaceOperation)."""
        if ns in self._ns_exact:
            return self._ns_exact[ns]
        pattern = _closest_glob(ns, self._ns_glob)
        return self._ns_glob[pattern] if pattern is not None else None

    def allow_namespace_op(self, ns: str, cap: str) -> bool:
        if self.management:
            return True
        caps = self._ns_caps(ns)
        if caps is None or CAP_DENY in caps:
            return False
        return cap in caps

    def allow_any_namespace(self, cap: str) -> bool:
        """Whether any namespace rule grants ``cap``: the list routes'
        check under ?namespace=* (upstream: acl.go AllowNsOpFunc over
        the wildcard namespace)."""
        if self.management:
            return True
        for caps in list(self._ns_exact.values()) + \
                list(self._ns_glob.values()):
            if cap in caps and CAP_DENY not in caps:
                return True
        return False

    def allow_namespace(self, ns: str) -> bool:
        """Any capability at all in ``ns`` (upstream: acl.go
        AllowNamespace)."""
        if self.management:
            return True
        caps = self._ns_caps(ns)
        return bool(caps) and CAP_DENY not in caps

    # -- variables ----------------------------------------------------------
    def allow_variable_op(self, ns: str, path: str, cap: str) -> bool:
        """The closest path rule of the namespace's (or its closest
        glob's) variables block decides; without one, the namespace's
        variables-<cap> capability does (upstream: acl.go
        AllowVariableOperation). Path rules' capabilities are expanded
        at parse time, and their deny wins."""
        if self.management:
            return True
        rules: List[VariablePathRule] = []
        if ns in self._ns_variables:
            rules = self._ns_variables[ns]
        else:
            pattern = _closest_glob(
                ns, [p for p in self._ns_variables if "*" in p])
            if pattern is not None:
                rules = self._ns_variables[pattern]
        best_rule: Optional[Tuple[int, VariablePathRule]] = None
        for rule in rules:
            if fnmatchcase(path, rule.path):
                key = len(rule.path.replace("*", ""))
                if best_rule is None or key > best_rule[0]:
                    best_rule = (key, rule)
        if best_rule is not None:
            caps = best_rule[1].capabilities
            if "deny" in caps:
                return False
            return cap in caps
        return self.allow_namespace_op(ns, f"variables-{cap}")

    # -- host volumes -------------------------------------------------------
    def allow_host_volume_op(self, name: str, cap: str) -> bool:
        if self.management:
            return True
        caps = self._hv_exact.get(name)
        if caps is None:
            pattern = _closest_glob(name, self._hv_glob)
            caps = self._hv_glob[pattern] if pattern is not None else None
        if caps is None or CAP_DENY in caps:
            return False
        return cap in caps

    # -- the coarse domains -------------------------------------------------
    def _coarse(self, level: str, need: str) -> bool:
        if self.management:
            return True
        if level == POLICY_DENY:
            return False
        if need == POLICY_READ:
            return level in (POLICY_READ, POLICY_WRITE)
        if need == POLICY_LIST:
            return level in (POLICY_LIST, POLICY_READ, POLICY_WRITE)
        return level == POLICY_WRITE

    def allow_node_read(self) -> bool:
        return self._coarse(self.node, POLICY_READ)

    def allow_node_write(self) -> bool:
        return self._coarse(self.node, POLICY_WRITE)

    def allow_agent_read(self) -> bool:
        return self._coarse(self.agent, POLICY_READ)

    def allow_agent_write(self) -> bool:
        return self._coarse(self.agent, POLICY_WRITE)

    def allow_operator_read(self) -> bool:
        return self._coarse(self.operator, POLICY_READ)

    def allow_operator_write(self) -> bool:
        return self._coarse(self.operator, POLICY_WRITE)

    def allow_quota_read(self) -> bool:
        return self._coarse(self.quota, POLICY_READ)

    def allow_quota_write(self) -> bool:
        return self._coarse(self.quota, POLICY_WRITE)

    def allow_plugin_read(self) -> bool:
        return self._coarse(self.plugin, POLICY_READ)

    def allow_plugin_list(self) -> bool:
        return self._coarse(self.plugin, POLICY_LIST)

    def is_management(self) -> bool:
        return self.management


MANAGEMENT_ACL = ACL(management=True)
# ACLs on and no token: the deny-all ACL
ANONYMOUS_ACL = ACL(management=False)
