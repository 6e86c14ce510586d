"""ACL storage structs (port of nomad_tpu/structs/acl.py; upstream:
nomad/structs/structs.go ACLPolicy, ACLRole and ACLToken). A policy's
rules are HCL text; the rules language lives in nomad_tpu_torch/acl/.
"""
from __future__ import annotations

import secrets
import time
import uuid
from dataclasses import dataclass, field
from typing import List, Optional

ACL_TOKEN_TYPE_CLIENT = "client"
ACL_TOKEN_TYPE_MANAGEMENT = "management"

# the accessor an anonymous request (ACLs on, no token) is known by
ANONYMOUS_TOKEN_ACCESSOR = "anonymous"


@dataclass
class ACLPolicy:
    """A named policy document as stored (upstream: structs.ACLPolicy)."""
    name: str
    description: str = ""
    rules: str = ""              # the HCL source
    create_index: int = 0
    modify_index: int = 0


@dataclass
class ACLRole:
    """A named set of policies a token may link to (upstream:
    structs.ACLRole)."""
    name: str = ""
    description: str = ""
    policies: List[str] = field(default_factory=list)
    create_index: int = 0
    modify_index: int = 0


@dataclass
class ACLToken:
    """(upstream: structs.ACLToken) ``roles`` link by name: a token
    resolves to its own policies and those of its roles."""
    accessor_id: str = ""
    secret_id: str = ""
    name: str = ""
    type: str = ACL_TOKEN_TYPE_CLIENT
    policies: List[str] = field(default_factory=list)
    roles: List[str] = field(default_factory=list)
    global_token: bool = False
    create_time: float = 0.0
    expiration_time: Optional[float] = None
    create_index: int = 0
    modify_index: int = 0

    @staticmethod
    def new(name: str = "", type: str = ACL_TOKEN_TYPE_CLIENT,
            policies: Optional[List[str]] = None,
            ttl_s: Optional[float] = None,
            roles: Optional[List[str]] = None) -> "ACLToken":
        """A fresh token: a random accessor id and a secret from the
        system's CSPRNG, expiring ``ttl_s`` seconds from now if given."""
        now = time.time()
        return ACLToken(
            accessor_id=str(uuid.uuid4()),
            secret_id=str(uuid.UUID(bytes=secrets.token_bytes(16))),
            name=name, type=type, policies=list(policies or []),
            roles=list(roles or []),
            create_time=now,
            expiration_time=(now + ttl_s) if ttl_s is not None else None)

    def is_management(self) -> bool:
        return self.type == ACL_TOKEN_TYPE_MANAGEMENT

    def is_expired(self, now: Optional[float] = None) -> bool:
        if not self.expiration_time:
            return False
        return (now if now is not None else time.time()) >= \
            self.expiration_time
