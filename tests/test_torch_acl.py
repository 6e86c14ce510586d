"""The port's ACLs (nomad_tpu_torch/acl/, structs/acl.py, the store's
ACL tables and the Server's bootstrap_acl / resolve_token) held against
the JAX package's on the CPU. Host logic only, so every comparison is
exact:

  * parse_policy on a corpus of HCL policies, valid and invalid: equal
    rules, or the same exception type and message;
  * every allow_* of the compiled ACL over a grid of policy sets x
    namespaces x capabilities (and variable paths, host volumes and the
    coarse domains);
  * the resolver on tokens carried from the reference (never minted
    apart): a deleted token, an expired one (the clock pinned), a
    changed policy, a role's policies, a management token, anonymous;
  * bootstrap: once, refused again, open again once every management
    token is gone.
"""
import dataclasses
import itertools
import time

import pytest

from nomad_tpu import acl as ref_acl
from nomad_tpu.acl import acl as ref_acl_mod
from nomad_tpu.acl import policy as ref_policy
from nomad_tpu.server import Server as RefServer
from nomad_tpu.state import StateStore as RefStateStore
from nomad_tpu.structs import ACLPolicy as RefACLPolicy
from nomad_tpu.structs import ACLRole as RefACLRole
from nomad_tpu.structs import ACLToken as RefACLToken

from nomad_tpu_torch import acl as port_acl
from nomad_tpu_torch.acl import acl as port_acl_mod
from nomad_tpu_torch.acl import policy as port_policy
from nomad_tpu_torch.carry import store_from_reference, struct_from_reference
from nomad_tpu_torch.server import Server
from nomad_tpu_torch.state.store import StateStore
from nomad_tpu_torch.structs import ACLPolicy, ACLRole, ACLToken

NOW = 1_700_000_000.0

POLICIES = {
    "empty": "",
    "default-read": 'namespace "default" { policy = "read" }',
    "default-write": 'namespace "default" { policy = "write" }',
    "team-write": '''
namespace "team-a" { policy = "write" }
node { policy = "write" }
''',
    "scale-only": 'namespace "default" { policy = "scale" }',
    "deny-default": '''
namespace "*" { policy = "read" }
namespace "default" { policy = "deny" }
''',
    "globs": '''
namespace "ops-*" { capabilities = ["list-jobs", "read-job"] }
namespace "ops-prod-*" { policy = "write" }
namespace "*" { capabilities = ["parse-job"] }
''',
    "caps": '''
namespace "default" {
  capabilities = ["submit-job", "dispatch-job", "read-logs", "alloc-exec"]
}
''',
    "variables": '''
namespace "default" {
  policy = "read"
  variables {
    path "nomad/jobs/*" { capabilities = ["write"] }
    path "nomad/jobs/secret" { capabilities = ["deny"] }
    path "shared/*" { capabilities = ["read"] }
  }
}
namespace "apps-*" {
  variables { path "*" { capabilities = ["list", "read"] } }
}
''',
    "coarse": '''
node     { policy = "read" }
agent    { policy = "write" }
operator { policy = "read" }
quota    { policy = "deny" }
plugin   { policy = "list" }
''',
    "coarse-merge": '''
node     { policy = "write" }
agent    { policy = "deny" }
plugin   { policy = "read" }
''',
    "host-volumes": '''
host_volume "prod-*" { policy = "write" }
host_volume "prod-db" { policy = "read" }
host_volume "scratch" { capabilities = ["mount-readonly"] }
host_volume "*" { policy = "deny" }
''',
    "unlabelled": '''
namespace { policy = "read" }
host_volume { policy = "read" }
''',
}

INVALID = [
    'namespace "default" { policy = "admin" }',
    'node { policy = "list" }',
    'plugin { policy = "write" }',
    'agent { policy = "scale" }',
    'namespace "default" { policy = ',
    'namespace "default" { policy = "read"',
    '}',
    'quota { policy = "bogus" }\nnode { policy = "read" }',
    'operator { policy = "read" }\noperator { policy = "sudo" }',
]

# policy sets compiled into one ACL each
SETS = [
    ("empty",), ("default-read",), ("default-write",), ("team-write",),
    ("scale-only",), ("deny-default",), ("globs",), ("caps",),
    ("variables",), ("coarse",), ("coarse", "coarse-merge"),
    ("host-volumes",), ("unlabelled",),
    ("default-read", "team-write", "coarse"),
    ("default-write", "deny-default"),
    ("globs", "variables", "scale-only"),
]

NAMESPACES = ["default", "team-a", "team-b", "ops-1", "ops-prod-eu",
              "apps-web", "other", "*"]
CAPS = sorted({v for k, v in vars(ref_policy).items()
               if k.startswith("CAP_")})
VAR_PATHS = ["nomad/jobs/web", "nomad/jobs/secret", "shared/cfg",
             "other/x", ""]
VAR_CAPS = ["list", "read", "write", "destroy", "deny"]
VOLUMES = ["prod-db", "prod-web", "scratch", "dev", "prod"]
VOL_CAPS = ["mount-readonly", "mount-readwrite"]
COARSE = ["allow_node_read", "allow_node_write", "allow_agent_read",
          "allow_agent_write", "allow_operator_read", "allow_operator_write",
          "allow_quota_read", "allow_quota_write", "allow_plugin_read",
          "allow_plugin_list", "is_management"]


def _outcome(fn, *args):
    try:
        return ("ok", dataclasses.asdict(fn(*args)))
    except Exception as e:  # noqa: BLE001 -- compared by type and text
        return ("error", type(e).__name__, str(e))


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_parse_policy_equals_the_reference(name):
    src = POLICIES[name]
    got = _outcome(port_policy.parse_policy, name, src)
    want = _outcome(ref_policy.parse_policy, name, src)
    assert got == want
    assert got[0] == "ok"


@pytest.mark.parametrize("k", range(len(INVALID)))
def test_parse_policy_refuses_as_the_reference(k):
    got = _outcome(port_policy.parse_policy, "bad", INVALID[k])
    want = _outcome(ref_policy.parse_policy, "bad", INVALID[k])
    assert got == want
    assert got[0] == "error", got


def test_policy_level_expansions_equal_the_reference():
    for level in ("deny", "read", "write", "scale", "list", "", "x"):
        assert _outcome(lambda lv: {"caps": port_policy.
                                    expand_namespace_policy(lv)}, level) \
            == _outcome(lambda lv: {"caps": ref_policy.
                                    expand_namespace_policy(lv)}, level)
    for caps in (["write"], ["read"], ["read", "write"], ["list", "deny"],
                 ["destroy", "list", "list"], []):
        assert port_policy.expand_variables_capabilities(caps) == \
            ref_policy.expand_variables_capabilities(caps)
    assert [c for c in dir(port_acl) if c.startswith(("CAP_", "POLICY_"))] \
        == [c for c in dir(ref_acl) if c.startswith(("CAP_", "POLICY_"))]


def _compiled(mod_policy, mod_acl, names):
    return mod_acl.ACL(policies=[mod_policy.parse_policy(n, POLICIES[n])
                                 for n in names])


def _decisions(acl):
    out = {}
    for ns, cap in itertools.product(NAMESPACES, CAPS):
        out[("ns_op", ns, cap)] = acl.allow_namespace_op(ns, cap)
    for ns in NAMESPACES:
        out[("ns", ns)] = acl.allow_namespace(ns)
    for cap in CAPS:
        out[("any", cap)] = acl.allow_any_namespace(cap)
    for ns, path, cap in itertools.product(NAMESPACES, VAR_PATHS, VAR_CAPS):
        out[("var", ns, path, cap)] = acl.allow_variable_op(ns, path, cap)
    for vol, cap in itertools.product(VOLUMES, VOL_CAPS):
        out[("hv", vol, cap)] = acl.allow_host_volume_op(vol, cap)
    for name in COARSE:
        out[(name,)] = getattr(acl, name)()
    return out


@pytest.mark.parametrize("names", SETS, ids=["+".join(s) for s in SETS])
def test_every_allow_equals_the_reference(names):
    got = _decisions(_compiled(port_policy, port_acl_mod, names))
    want = _decisions(_compiled(ref_policy, ref_acl_mod, names))
    diff = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    assert not diff, diff


def test_management_and_anonymous_acls_equal_the_reference():
    assert _decisions(port_acl.MANAGEMENT_ACL) == \
        _decisions(ref_acl.MANAGEMENT_ACL)
    assert _decisions(port_acl.ANONYMOUS_ACL) == \
        _decisions(ref_acl.ANONYMOUS_ACL)
    assert all(_decisions(port_acl.MANAGEMENT_ACL).values())
    assert not any(_decisions(port_acl.ANONYMOUS_ACL).values())


# -- the resolver ------------------------------------------------------------

def _world(monkeypatch):
    """A reference store with policies, a role and tokens, and the port
    store carried from it (the tokens themselves, never minted apart)."""
    monkeypatch.setattr(time, "time", lambda: NOW)
    ref = RefStateStore()
    ref.upsert_acl_policies([
        RefACLPolicy(name=n, rules=POLICIES[n])
        for n in ("default-read", "team-write", "coarse", "globs")])
    ref.upsert_acl_roles([RefACLRole(name="ops",
                                     policies=["globs", "coarse"])])
    tokens = {
        "ro": RefACLToken.new(name="ro", policies=["default-read"]),
        "rw": RefACLToken.new(name="rw", policies=["team-write",
                                                   "missing"]),
        "role": RefACLToken.new(name="role", roles=["ops", "nope"],
                                policies=["default-read"]),
        "short": RefACLToken.new(name="short", policies=["default-read"],
                                 ttl_s=30.0),
        "mgmt": RefACLToken.new(name="m", type="management"),
    }
    ref.upsert_acl_tokens(list(tokens.values()))
    port = store_from_reference(ref.snapshot())
    return ref, port, tokens


def _resolve_all(ref_srv, port_srv, tokens):
    out = {}
    for name, tok in list(tokens.items()) + [("anon", None), ("junk", "x"),
                                             ("jwt", "a.b.c")]:
        secret = tok if isinstance(tok, (str, type(None))) \
            else tok.secret_id
        (pa, pt), (ra, rt) = (port_srv.resolve_token(secret),
                              ref_srv.resolve_token(secret))
        assert _decisions(pa) == _decisions(ra), name
        assert (pt is None) == (rt is None), name
        if pt is not None:
            assert dataclasses.asdict(pt) == dataclasses.asdict(rt)
        out[name] = (pt.accessor_id if pt is not None else None,
                     pa.is_management(), pa.allow_node_read())
    return out


def test_resolver_follows_deletes_expiry_and_policy_changes(monkeypatch):
    ref, port, tokens = _world(monkeypatch)
    ref_srv = RefServer(state=ref, acl_enabled=True)
    port_srv = Server(state=port, acl_enabled=True, device="cpu")
    first = _resolve_all(ref_srv, port_srv, tokens)
    assert first["mgmt"][1] and first["anon"] == (None, False, False)
    assert first["role"][2]              # node read through the role
    # the same requests again hit the resolver's cache in both
    assert _resolve_all(ref_srv, port_srv, tokens) == first
    # a changed policy takes effect on the next request
    for store, cls in ((ref, RefACLPolicy), (port, ACLPolicy)):
        store.upsert_acl_policies([cls(name="default-read",
                                       rules=POLICIES["default-write"])])
    changed = _resolve_all(ref_srv, port_srv, tokens)
    assert port_srv.resolve_token(tokens["ro"].secret_id)[0]\
        .allow_namespace_op("default", "submit-job")
    # a changed role too
    for store, cls in ((ref, RefACLRole), (port, ACLRole)):
        store.upsert_acl_roles([cls(name="ops", policies=[])])
    _resolve_all(ref_srv, port_srv, tokens)
    assert not port_srv.resolve_token(tokens["role"].secret_id)[0]\
        .allow_node_read()
    # a deleted token is anonymous on the next request
    for store in (ref, port):
        store.delete_acl_tokens([tokens["rw"].accessor_id])
    gone = _resolve_all(ref_srv, port_srv, tokens)
    assert gone["rw"] == (None, False, False)
    assert changed["rw"] != gone["rw"]
    # an expired token too, the clock moved past its TTL
    assert gone["short"][0] == tokens["short"].accessor_id
    monkeypatch.setattr(time, "time", lambda: NOW + 31.0)
    late = _resolve_all(ref_srv, port_srv, tokens)
    assert late["short"] == (None, False, False)
    assert late["ro"][0] == tokens["ro"].accessor_id


def test_acls_off_resolve_to_management():
    ref_srv = RefServer(state=RefStateStore())
    port_srv = Server(state=StateStore(), device="cpu")
    for secret in (None, "", "x"):
        assert port_srv.resolve_token(secret)[0] is port_acl.MANAGEMENT_ACL
        assert ref_srv.resolve_token(secret)[0] is ref_acl.MANAGEMENT_ACL


def test_bootstrap_once_then_again_without_management(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: NOW)
    ref_srv = RefServer(state=RefStateStore(), acl_enabled=True)
    port_srv = Server(state=StateStore(), acl_enabled=True, device="cpu")
    marks = []
    for srv in (ref_srv, port_srv):
        assert not srv.state.acl_bootstrapped()
        tok = srv.bootstrap_acl()
        assert tok is not None and tok.is_management() and tok.global_token
        assert tok.name == "Bootstrap Token"
        assert srv.state.acl_bootstrapped()
        assert srv.bootstrap_acl() is None
        assert srv.resolve_token(tok.secret_id)[0].is_management()
        srv.state.delete_acl_tokens([tok.accessor_id])
        again = srv.bootstrap_acl()
        assert again is not None and again.secret_id != tok.secret_id
        marks.append((tok.create_index, again.create_index,
                      srv.state.latest_index(),
                      srv.state.table_index("acl_tokens")))
    assert marks[0] == marks[1]


def test_token_struct_equals_the_reference(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: NOW)
    mine = ACLToken.new(name="n", policies=["p"], ttl_s=5.0, roles=["r"])
    theirs = RefACLToken.new(name="n", policies=["p"], ttl_s=5.0,
                             roles=["r"])
    a, b = dataclasses.asdict(mine), dataclasses.asdict(theirs)
    for k in ("accessor_id", "secret_id"):
        assert len(a.pop(k)) == len(b.pop(k)) == 36
    assert a == b
    carried = struct_from_reference(theirs)
    assert dataclasses.asdict(carried) == dataclasses.asdict(theirs)
    for now in (NOW, NOW + 4.9, NOW + 5.0, None):
        assert carried.is_expired(now) == theirs.is_expired(now)
    assert not carried.is_management()
