"""Search: prefix and fuzzy lookups across the cluster's objects (port
of nomad_tpu/server/search.py; upstream: nomad/search_endpoint.go
PrefixSearch :589, FuzzySearch :728, getPrefixMatches :60,
getFuzzyMatches :113, fuzzyIndex :199, truncateLimit :26). Matches are
read from the store, grouped by context and cut at 20 a context, with a
truncations marker, as upstream does. The port's store has no CSI or
variables tables yet: those contexts find nothing.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

TRUNCATE_LIMIT = 20

# searchable contexts (upstream: search_endpoint.go ossContexts)
CONTEXT_JOBS = "jobs"
CONTEXT_EVALS = "evals"
CONTEXT_ALLOCS = "allocs"
CONTEXT_NODES = "nodes"
CONTEXT_DEPLOYMENTS = "deployment"
CONTEXT_NAMESPACES = "namespaces"
CONTEXT_NODE_POOLS = "node_pools"
CONTEXT_SCALING_POLICIES = "scaling_policy"
CONTEXT_VARIABLES = "variables"
CONTEXT_PLUGINS = "plugins"
CONTEXT_VOLUMES = "volumes"
CONTEXT_ALL = "all"

ALL_CONTEXTS = (
    CONTEXT_JOBS, CONTEXT_EVALS, CONTEXT_ALLOCS, CONTEXT_NODES,
    CONTEXT_DEPLOYMENTS, CONTEXT_NAMESPACES, CONTEXT_NODE_POOLS,
    CONTEXT_SCALING_POLICIES, CONTEXT_VARIABLES, CONTEXT_PLUGINS,
    CONTEXT_VOLUMES,
)


def fuzzy_index(name: str, text: str) -> int:
    """Case-insensitive substring index (upstream: fuzzyIndex :199)."""
    return name.lower().find(text.lower())


def _truncate(ids: List[str]) -> Tuple[List[str], bool]:
    if len(ids) > TRUNCATE_LIMIT:
        return ids[:TRUNCATE_LIMIT], True
    return ids, False


class Searcher:
    """Searches over a store. ``ns_allowed`` is the ACL filter: an
    object in a namespace the token cannot read is not found, under
    namespace "*" too (upstream: the search endpoints filter each object
    as the list endpoints do)."""

    def __init__(self, state, ns_allowed=None):
        self.state = state
        self.ns_allowed = ns_allowed or (lambda ns: True)

    def _ns_ok(self, namespace: Optional[str], obj_ns: str) -> bool:
        if namespace not in (None, "*") and obj_ns != namespace:
            return False
        return self.ns_allowed(obj_ns)

    # -- candidate id streams per context -----------------------------------
    def _ids(self, context: str, namespace: Optional[str]) -> List[str]:
        s = self.state
        if context == CONTEXT_JOBS:
            return sorted(j.id for j in s.jobs()
                          if self._ns_ok(namespace, j.namespace))
        if context == CONTEXT_EVALS:
            return sorted(e.id for e in s.evals()
                          if self._ns_ok(namespace, e.namespace))
        if context == CONTEXT_ALLOCS:
            return sorted(a.id for a in s.allocs()
                          if self._ns_ok(namespace, a.namespace))
        if context == CONTEXT_NODES:
            return sorted(n.id for n in s.nodes())
        if context == CONTEXT_DEPLOYMENTS:
            return sorted(d.id for d in s.deployments()
                          if self._ns_ok(namespace, d.namespace))
        if context == CONTEXT_NAMESPACES:
            if hasattr(s, "namespaces"):
                return sorted(n.name for n in s.namespaces()
                              if self.ns_allowed(n.name))
            return ["default"]
        if context == CONTEXT_NODE_POOLS:
            if hasattr(s, "node_pools"):
                return sorted(p.name for p in s.node_pools())
            return []
        if context == CONTEXT_SCALING_POLICIES:
            return sorted(p.id for p in s.scaling_policies(
                None if namespace in (None, "*") else namespace)
                if self.ns_allowed(p.namespace))
        if context == CONTEXT_VARIABLES:
            return sorted(v.path for v in s.variables(
                None if namespace in (None, "*") else namespace)
                if self.ns_allowed(v.meta.namespace))
        if context == CONTEXT_PLUGINS and hasattr(s, "csi_plugins"):
            return sorted(p.id for p in s.csi_plugins())
        if context == CONTEXT_VOLUMES and hasattr(s, "csi_volumes"):
            return sorted(v.id for v in s.csi_volumes()
                          if self._ns_ok(namespace, v.namespace))
        return []

    # -- prefix search -------------------------------------------------------
    def prefix_search(self, prefix: str, context: str = CONTEXT_ALL,
                      namespace: Optional[str] = None,
                      allowed_contexts: Optional[List[str]] = None
                      ) -> Dict[str, object]:
        """(upstream: PrefixSearch :589) Returns
        {"matches": {ctx: [ids]}, "truncations": {ctx: bool}}."""
        contexts = (list(ALL_CONTEXTS) if context == CONTEXT_ALL
                    else [context])
        if allowed_contexts is not None:
            contexts = [c for c in contexts if c in allowed_contexts]
        matches: Dict[str, List[str]] = {}
        truncations: Dict[str, bool] = {}
        for ctx in contexts:
            ids = [i for i in self._ids(ctx, namespace)
                   if i.startswith(prefix)]
            ids, truncated = _truncate(ids)
            if ids or context != CONTEXT_ALL:
                matches[ctx] = ids
            if truncated:
                truncations[ctx] = True
        return {"matches": matches, "truncations": truncations}

    # -- fuzzy search --------------------------------------------------------
    def fuzzy_search(self, text: str, context: str = CONTEXT_ALL,
                     namespace: Optional[str] = None,
                     allowed_contexts: Optional[List[str]] = None
                     ) -> Dict[str, object]:
        """(upstream: FuzzySearch :728) A case-insensitive substring
        match on names; jobs also match their groups' and tasks' names,
        with scopes. Ids (evals, allocs, deployments) stay prefix-matched,
        as upstream's. Returns {"matches": {ctx: [{id, scope}]},
        "truncations": {ctx: bool}}."""
        contexts = (list(ALL_CONTEXTS) if context == CONTEXT_ALL
                    else [context])
        if allowed_contexts is not None:
            contexts = [c for c in contexts if c in allowed_contexts]
        out: Dict[str, List[dict]] = {}
        truncations: Dict[str, bool] = {}

        def add(ctx: str, scored: List[Tuple[int, int, dict]]) -> None:
            # order: earliest match index, then shortest name
            # (upstream: sortSet in getFuzzyMatches)
            scored.sort(key=lambda t: (t[0], t[1]))
            items = [m for _, _, m in scored]
            if len(items) > TRUNCATE_LIMIT:
                items = items[:TRUNCATE_LIMIT]
                truncations[ctx] = True
            if items or context != CONTEXT_ALL:
                out[ctx] = items

        s = self.state
        for ctx in contexts:
            if ctx == CONTEXT_JOBS:
                scored = []
                groups: List[Tuple[int, int, dict]] = []
                tasks: List[Tuple[int, int, dict]] = []
                for j in s.jobs():
                    if not self._ns_ok(namespace, j.namespace):
                        continue
                    idx = fuzzy_index(j.name, text)
                    if idx >= 0:
                        scored.append((idx, len(j.name), {
                            "id": j.name,
                            "scope": [j.namespace, j.id]}))
                    for tg in j.task_groups:
                        gidx = fuzzy_index(tg.name, text)
                        if gidx >= 0:
                            groups.append((gidx, len(tg.name), {
                                "id": tg.name,
                                "scope": [j.namespace, j.id]}))
                        for t in tg.tasks:
                            tidx = fuzzy_index(t.name, text)
                            if tidx >= 0:
                                tasks.append((tidx, len(t.name), {
                                    "id": t.name,
                                    "scope": [j.namespace, j.id, tg.name]}))
                add(ctx, scored)
                if groups:
                    add("groups", groups)
                if tasks:
                    add("tasks", tasks)
            elif ctx == CONTEXT_NODES:
                scored = []
                for n in s.nodes():
                    idx = fuzzy_index(n.name, text)
                    if idx >= 0:
                        scored.append((idx, len(n.name),
                                       {"id": n.name, "scope": [n.id]}))
                add(ctx, scored)
            elif ctx in (CONTEXT_NAMESPACES, CONTEXT_NODE_POOLS,
                         CONTEXT_VARIABLES):
                scored = []
                for name in self._ids(ctx, namespace):
                    idx = fuzzy_index(name, text)
                    if idx >= 0:
                        scored.append((idx, len(name),
                                       {"id": name, "scope": []}))
                add(ctx, scored)
            else:
                # objects addressed by id stay prefix-matched
                # (upstream: FuzzySearch expandContext)
                ids = [i for i in self._ids(ctx, namespace)
                       if i.startswith(text)]
                ids, truncated = _truncate(ids)
                if truncated:
                    truncations[ctx] = True
                if ids or context != CONTEXT_ALL:
                    out[ctx] = [{"id": i, "scope": []} for i in ids]
        return {"matches": out, "truncations": truncations}
