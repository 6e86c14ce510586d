"""ACLs (port of nomad_tpu/acl/; upstream: acl/ and nomad/auth/): the
policy language (policy.py), the compiled capability checks (acl.py)
and ``Resolver``, which turns a request's secret into a compiled ACL.
The structs are in structs/acl.py, their tables in state/store.py.
"""
import threading

from .acl import ACL, ANONYMOUS_ACL, MANAGEMENT_ACL  # noqa: F401
from .policy import (  # noqa: F401
    CAP_ALLOC_EXEC, CAP_ALLOC_LIFECYCLE, CAP_CSI_LIST_VOLUME,
    CAP_CSI_MOUNT_VOLUME, CAP_CSI_READ_VOLUME, CAP_CSI_REGISTER_PLUGIN,
    CAP_CSI_WRITE_VOLUME, CAP_DISPATCH_JOB, CAP_LIST_JOBS,
    CAP_LIST_SCALING_POLICIES, CAP_PARSE_JOB, CAP_READ_FS, CAP_READ_JOB,
    CAP_READ_JOB_SCALING, CAP_READ_LOGS, CAP_READ_SCALING_POLICY,
    CAP_SCALE_JOB, CAP_SUBMIT_JOB, CAP_VARIABLES_DESTROY, CAP_VARIABLES_LIST,
    CAP_VARIABLES_READ, CAP_VARIABLES_WRITE,
    POLICY_DENY, POLICY_LIST, POLICY_READ, POLICY_SCALE, POLICY_WRITE,
    Policy, expand_namespace_policy, parse_policy,
)


class Resolver:
    """Secrets to compiled ACLs (upstream: nomad/auth/auth.go and the
    ACL cache of nomad/acl.go ResolveToken). A client token's compiled
    ACL is cached by accessor under the (tokens, policies, roles) table
    indexes: any write to those tables empties the cache, so a changed
    policy or role takes effect on the next request. A deleted or
    expired token resolves to nothing."""

    def __init__(self, state):
        self.state = state
        self._lock = threading.Lock()
        self._cache = {}
        self._cache_key = (-1, -1, -1)

    def resolve_secret(self, secret_id):
        """-> (ACL, token), or (None, None) for an unknown or expired
        secret."""
        from ..structs import ACL_TOKEN_TYPE_MANAGEMENT

        # the key is read BEFORE the token and its policies, and a
        # compiled ACL is kept only under the key it was built from: a
        # policy written meanwhile cannot leave a stale compile cached
        # under the fresh key
        key = (self.state.table_index("acl_tokens"),
               self.state.table_index("acl_policies"),
               self.state.table_index("acl_roles"))
        with self._lock:
            if key != self._cache_key:
                self._cache = {}
                self._cache_key = key
        token = self.state.acl_token_by_secret(secret_id)
        if token is None or token.is_expired():
            return None, None
        if token.type == ACL_TOKEN_TYPE_MANAGEMENT:
            return MANAGEMENT_ACL, token
        cache_id = token.accessor_id
        with self._lock:
            if key == self._cache_key and cache_id in self._cache:
                return self._cache[cache_id], token
        # the token's own policies, then its roles'
        names = list(token.policies)
        for role_name in token.roles or []:
            role = self.state.acl_role_by_name(role_name)
            if role is not None:
                names.extend(role.policies)
        policies = []
        seen = set()
        for name in names:
            if name in seen:
                continue
            seen.add(name)
            stored = self.state.acl_policy_by_name(name)
            if stored is not None:
                policies.append(parse_policy(stored.name, stored.rules))
        compiled = ACL(policies=policies)
        with self._lock:
            if key == self._cache_key:
                self._cache[cache_id] = compiled
        return compiled, token
