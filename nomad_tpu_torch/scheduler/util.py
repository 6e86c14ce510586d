"""Deterministic node shuffle and target resolution (port of
nomad_tpu/scheduler/util.py).

The shuffle decides tie-breaks between equal-score nodes, so its order must
match the reference bit for bit: same seeding contract (last 8 bytes of the
eval ID XOR the refresh index) and the same splitmix64 Fisher-Yates.
``resolve_target`` resolves a ``${...}`` interpolation against a node.
"""
from __future__ import annotations

from typing import List, Tuple

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
