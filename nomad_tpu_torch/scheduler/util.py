"""Scheduler utilities (port of nomad_tpu/scheduler/util.py; upstream:
scheduler/util.go): the deterministic node shuffle, tainted nodes, the
retry loop and its progress test, alloc names, and target resolution.

The shuffle decides tie-breaks between equal-score nodes, so its order must
match the reference bit for bit: same seeding contract (last 8 bytes of the
eval ID XOR the refresh index) and the same splitmix64 Fisher-Yates.
``resolve_target`` resolves a ``${...}`` interpolation against a node.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..structs import NODE_STATUS_DISCONNECTED, NODE_STATUS_DOWN

MASK64 = (1 << 64) - 1


def splitmix64(state: int) -> Tuple[int, int]:
    """One step of splitmix64; returns (new_state, output)."""
    state = (state + 0x9E3779B97F4A7C15) & MASK64
    z = state
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & MASK64
    z = z ^ (z >> 31)
    return state, z


def shuffle_seed(eval_id: str, index: int) -> int:
    """Derive the shuffle seed from eval ID + refresh index
    (reference contract: util.go:167-177)."""
    raw = eval_id.encode()[-8:].rjust(8, b"\0")
    seed = int.from_bytes(raw, "big") ^ (index & MASK64)
    return seed & MASK64


def shuffle_nodes(plan, index: int, nodes: list) -> None:
    """In-place deterministic Fisher-Yates of ``nodes``, seeded by the
    plan's eval id and ``index`` (upstream: util.go shuffleNodes); the
    same permutation as shuffled_order."""
    state = shuffle_seed(plan.eval_id, index)
    for i in range(len(nodes) - 1, 0, -1):
        state, out = splitmix64(state)
        j = out % (i + 1)
        nodes[i], nodes[j] = nodes[j], nodes[i]


def shuffled_order(eval_id: str, index: int, n: int) -> List[int]:
    """The permutation the host shuffle applies, as index positions:
    order[i] is the original index of the node at shuffled position i."""
    order = list(range(n))
    state = shuffle_seed(eval_id, index)
    for i in range(n - 1, 0, -1):
        state, out = splitmix64(state)
        j = out % (i + 1)
        order[i], order[j] = order[j], order[i]
    return order


def resolve_target(target: str, node):
    """Resolve an interpolation target like ${attr.kernel.name} against a
    node (reference: feasible.go resolveTarget). Returns (value, found)."""
    if not target.startswith("${"):
        # raw values are returned as-is (constraint RTarget side)
        return target, True
    inner = target[2:-1] if target.endswith("}") else target[2:]
    if inner == "node.unique.id":
        return node.id, True
    if inner == "node.datacenter":
        return node.datacenter, True
    if inner == "node.unique.name":
        return node.name, True
    if inner == "node.class":
        return node.node_class, True
    if inner == "node.pool":
        return node.node_pool, True
    if inner.startswith("attr."):
        key = inner[len("attr."):]
        if key in node.attributes:
            return node.attributes[key], True
        return "", False
    if inner.startswith("meta."):
        key = inner[len("meta."):]
        if key in node.meta:
            return node.meta[key], True
        return "", False
    return "", False


def tainted_nodes(state, allocs) -> Dict[str, Optional[object]]:
    """Node id -> node for the allocs' nodes that are down, draining or
    disconnected, and -> None for those no longer registered
    (upstream: util.go taintedNodes)."""
    out: Dict[str, Optional[object]] = {}
    for alloc in allocs:
        if alloc.node_id in out:
            continue
        node = state.node_by_id(alloc.node_id)
        if node is None:
            out[alloc.node_id] = None
        elif (node.status in (NODE_STATUS_DOWN, NODE_STATUS_DISCONNECTED)
              or node.drain):
            out[alloc.node_id] = node
    return out


def retry_max(max_attempts: int, cb, reset_cb=None):
    """Call ``cb`` (returning (done, err)) until it is done, at most
    ``max_attempts`` times in a row without progress (``reset_cb``
    true restarts the count); returns None, or the SetStatusError of the
    exhausted attempts (upstream: util.go retryMax)."""
    attempts = 0
    while attempts < max_attempts:
        done, _err = cb()
        if done:
            return None
        if reset_cb is not None and reset_cb():
            attempts = 0
        else:
            attempts += 1
    from .generic import SetStatusError
    return SetStatusError(f"maximum attempts reached ({max_attempts})")


def progress_made(result) -> bool:
    """Did a plan's application commit anything? (upstream: util.go
    progressMade)"""
    return result is not None and bool(
        result.node_update or result.node_allocation
        or result.deployment is not None or result.deployment_updates)


def alloc_name(job_id: str, tg_name: str, idx: int) -> str:
    return f"{job_id}.{tg_name}[{idx}]"
