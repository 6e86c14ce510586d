"""Python client of the /v1/* HTTP API (port of nomad_tpu/api/client.py;
upstream: the api/ Go module, api.go Client with a file per resource:
jobs.go, allocations.go, nodes.go, evaluations.go, scaling.go,
operator.go, event_stream.go), for the routes the port's agent serves
(api/http.py), namespaces, node pools, the service catalog, search and
ACLs included; a client made with a ``token`` sends it as X-Nomad-Token
on every request. ``HttpServerConn`` is the node agent's transport over
the API: register, heartbeat, pull allocs, update allocs, register
services, get an alloc.
"""
from __future__ import annotations

import json
import urllib.error
import urllib.parse
import urllib.request
from typing import Any, Dict, List, Optional

from ..structs import Allocation, Node, codec


class ApiError(Exception):
    def __init__(self, status: int, msg: str):
        super().__init__(f"HTTP {status}: {msg}")
        self.status = status


class ApiClient:
    """(upstream: api/api.go Client)"""

    def __init__(self, address: str = "http://127.0.0.1:4646",
                 namespace: str = "default", token: str = "",
                 timeout: float = 10.0,
                 ca_cert: str = "", client_cert: str = "",
                 client_key: str = ""):
        import os as _os
        self.address = address.rstrip("/")
        self.namespace = namespace
        self.token = token
        self.timeout = timeout
        # TLS to an https agent (upstream: api/api.go TLSConfig +
        # NOMAD_CACERT/NOMAD_CLIENT_CERT/NOMAD_CLIENT_KEY env)
        ca_cert = ca_cert or _os.environ.get("NOMAD_CACERT", "")
        client_cert = client_cert or _os.environ.get("NOMAD_CLIENT_CERT", "")
        client_key = client_key or _os.environ.get("NOMAD_CLIENT_KEY", "")
        self._ssl_ctx = None
        if self.address.startswith("https"):
            from ..tlsutil import TLSConfig, client_context
            self._ssl_ctx = client_context(TLSConfig(
                ca_file=ca_cert, cert_file=client_cert,
                key_file=client_key))

    # -- low-level -----------------------------------------------------
    def _url(self, path: str, params: Optional[Dict[str, Any]] = None) -> str:
        params = dict(params or {})
        params.setdefault("namespace", self.namespace)
        qs = urllib.parse.urlencode(params)
        return f"{self.address}{path}?{qs}"

    def _do(self, req: urllib.request.Request,
            timeout: Optional[float] = None) -> bytes:
        """Shared urlopen + HTTPError->ApiError translation."""
        try:
            with urllib.request.urlopen(req, context=self._ssl_ctx,
                                        timeout=timeout or self.timeout
                                        ) as resp:
                return resp.read()
        except urllib.error.HTTPError as e:
            try:
                detail = json.loads(e.read()).get("error", str(e))
            except Exception:   # noqa: BLE001
                detail = str(e)
            raise ApiError(e.code, detail) from e

    def request(self, method: str, path: str,
                body: Optional[dict] = None,
                params: Optional[Dict[str, Any]] = None,
                timeout: Optional[float] = None) -> Any:
        req = urllib.request.Request(
            self._url(path, params), method=method,
            data=None if body is None else json.dumps(body).encode(),
            headers={"Content-Type": "application/json",
                     **({"X-Nomad-Token": self.token}
                        if self.token else {})})
        return json.loads(self._do(req, timeout) or b"null")

    def get(self, path: str, **params) -> Any:
        return self.request("GET", path, params=params)

    def post(self, path: str, body: Optional[dict] = None, **params) -> Any:
        return self.request("POST", path, body=body, params=params)

    def delete(self, path: str, **params) -> Any:
        return self.request("DELETE", path, params=params)

    # -- jobs (upstream: api/jobs.go) ---------------------------------
    def jobs(self) -> List[dict]:
        return self.get("/v1/jobs")

    def job(self, job_id: str) -> dict:
        return self.get(f"/v1/job/{job_id}")

    def register_job(self, job: dict) -> dict:
        return self.post("/v1/jobs", {"job": job})

    def register_job_hcl(self, hcl: str,
                         variables: Optional[dict] = None) -> dict:
        return self.post("/v1/jobs", {"job_hcl": hcl,
                                      "variables": variables or {}})

    def parse_job(self, hcl: str, variables: Optional[dict] = None) -> dict:
        return self.post("/v1/jobs/parse", {"job_hcl": hcl,
                                            "variables": variables or {}})

    def plan_job(self, job_id: str, job: Optional[dict] = None,
                 hcl: Optional[str] = None,
                 variables: Optional[dict] = None) -> dict:
        """A dry run of a JSON job, or of HCL the server parses."""
        body: Dict[str, Any] = {}
        if hcl is not None:
            body["job_hcl"] = hcl
            body["variables"] = variables or {}
        else:
            body["job"] = job or {}
        return self.post(f"/v1/job/{job_id}/plan", body)

    def deregister_job(self, job_id: str, purge: bool = False) -> dict:
        return self.delete(f"/v1/job/{job_id}",
                           purge="true" if purge else "false")

    def job_allocations(self, job_id: str) -> List[dict]:
        return self.get(f"/v1/job/{job_id}/allocations")

    def job_evaluations(self, job_id: str) -> List[dict]:
        return self.get(f"/v1/job/{job_id}/evaluations")

    def job_deployment(self, job_id: str) -> Optional[dict]:
        return self.get(f"/v1/job/{job_id}/deployment")

    def job_versions(self, job_id: str) -> dict:
        return self.get(f"/v1/job/{job_id}/versions")

    def revert_job(self, job_id: str, version: int,
                   enforce_prior_version: Optional[int] = None) -> dict:
        return self.post(f"/v1/job/{job_id}/revert",
                         {"job_version": version,
                          "enforce_prior_version": enforce_prior_version})

    def stabilize_job(self, job_id: str, version: int,
                      stable: bool = True) -> dict:
        return self.post(f"/v1/job/{job_id}/stable",
                         {"job_version": version, "stable": stable})

    def dispatch_job(self, job_id: str, payload: bytes = b"",
                     meta: Optional[dict] = None,
                     idempotency_token: str = "") -> dict:
        import base64
        return self.post(f"/v1/job/{job_id}/dispatch", {
            "payload": base64.b64encode(payload).decode(),
            "meta": meta or {}, "idempotency_token": idempotency_token})

    def scale_job(self, job_id: str, group: str, count: int,
                  message: str = "") -> dict:
        return self.post(f"/v1/job/{job_id}/scale", {
            "count": count, "target": {"Group": group}, "message": message})

    def job_scale_status(self, job_id: str) -> dict:
        return self.get(f"/v1/job/{job_id}/scale")

    # -- scaling policies (upstream: api/scaling.go) -------------------
    def scaling_policies(self, job: Optional[str] = None) -> List[dict]:
        params = {"job": job} if job else {}
        return self.get("/v1/scaling/policies", **params)

    def scaling_policy(self, policy_id: str) -> dict:
        return self.get(f"/v1/scaling/policy/{policy_id}")

    # -- namespaces and node pools (upstream: api/namespace.go,
    #    api/node_pools.go) -------------------------------------------
    def namespaces(self) -> List[dict]:
        return self.get("/v1/namespaces")

    def get_namespace(self, name: str) -> dict:
        # (get_*: .namespace is the client's query namespace)
        return self.get(f"/v1/namespace/{name}")

    def upsert_namespace(self, name: str, **fields) -> dict:
        return self.post(f"/v1/namespace/{name}",
                         {"name": name, **fields})

    def delete_namespace(self, name: str) -> dict:
        return self.delete(f"/v1/namespace/{name}")

    def node_pools(self) -> List[dict]:
        return self.get("/v1/node/pools")

    def node_pool(self, name: str) -> dict:
        return self.get(f"/v1/node/pool/{name}")

    def node_pool_nodes(self, name: str) -> List[dict]:
        return self.get(f"/v1/node/pool/{name}/nodes")

    def upsert_node_pool(self, name: str, **fields) -> dict:
        return self.post(f"/v1/node/pool/{name}", {"name": name, **fields})

    def delete_node_pool(self, name: str) -> dict:
        return self.delete(f"/v1/node/pool/{name}")

    # -- the native service catalog (upstream: api/services.go) --------
    def services(self) -> List[dict]:
        return self.get("/v1/services")

    def service(self, name: str) -> List[dict]:
        return self.get(f"/v1/service/{name}")

    def delete_service_registration(self, name: str, reg_id: str) -> dict:
        return self.delete(f"/v1/service/{name}/{reg_id}")

    # -- search (upstream: api/search.go) ------------------------------
    def search(self, prefix: str, context: str = "all") -> dict:
        return self.post("/v1/search",
                         {"prefix": prefix, "context": context})

    def fuzzy_search(self, text: str, context: str = "all") -> dict:
        return self.post("/v1/search/fuzzy",
                         {"text": text, "context": context})

    # -- ACLs (upstream: api/acl.go) -----------------------------------
    def acl_bootstrap(self) -> dict:
        return self.post("/v1/acl/bootstrap")

    def acl_policy_apply(self, name: str, rules: str,
                         description: str = "") -> dict:
        return self.post(f"/v1/acl/policy/{name}",
                         {"rules": rules, "description": description})

    def acl_policies(self) -> List[dict]:
        return self.get("/v1/acl/policies")

    def acl_token_create(self, name: str = "", type: str = "client",
                         policies: Optional[List[str]] = None,
                         roles: Optional[List[str]] = None,
                         ttl_s: Optional[float] = None) -> dict:
        body: Dict[str, Any] = {"name": name, "type": type,
                                "policies": policies or [],
                                "roles": roles or []}
        if ttl_s is not None:
            body["ttl_s"] = ttl_s
        return self.post("/v1/acl/token", body)

    def acl_token_self(self) -> dict:
        return self.get("/v1/acl/token/self")

    def acl_tokens(self) -> List[dict]:
        return self.get("/v1/acl/tokens")

    # -- nodes (upstream: api/nodes.go) -------------------------------
    def nodes(self) -> List[dict]:
        return self.get("/v1/nodes")

    def node(self, node_id: str) -> dict:
        return self.get(f"/v1/node/{node_id}")

    def drain_node(self, node_id: str, enable: bool = True,
                   deadline_s: float = 3600.0) -> dict:
        spec = {"deadline_s": deadline_s} if enable else None
        return self.post(f"/v1/node/{node_id}/drain",
                         {"drain_spec": spec})

    def node_eligibility(self, node_id: str, eligible: bool) -> dict:
        return self.post(f"/v1/node/{node_id}/eligibility",
                         {"eligibility":
                          "eligible" if eligible else "ineligible"})

    # -- allocs / evals / deployments ----------------------------------
    def allocations(self) -> List[dict]:
        return self.get("/v1/allocations")

    def allocation(self, alloc_id: str) -> dict:
        return self.get(f"/v1/allocation/{alloc_id}")

    def evaluations(self) -> List[dict]:
        return self.get("/v1/evaluations")

    def evaluation(self, eval_id: str) -> dict:
        return self.get(f"/v1/evaluation/{eval_id}")

    def deployments(self) -> List[dict]:
        return self.get("/v1/deployments")

    # -- operator / system (upstream: api/operator.go) ----------------
    def scheduler_config(self) -> dict:
        return self.get("/v1/operator/scheduler/configuration")

    def set_scheduler_config(self, **cfg) -> dict:
        return self.post("/v1/operator/scheduler/configuration", cfg)

    def leader(self) -> str:
        return self.get("/v1/status/leader")

    def system_gc(self) -> dict:
        return self.post("/v1/system/gc")

    def metrics(self) -> dict:
        return self.get("/v1/metrics")

    def event_stream(self, topics: Optional[List[str]] = None,
                     index: int = 0):
        """Generator over the live NDJSON event stream
        (upstream: api/event_stream.go). topics: ["Topic:Key", ...]."""
        params = [("namespace", self.namespace), ("index", str(index))]
        params += [("topic", t) for t in (topics or [])]
        qs = urllib.parse.urlencode(params)
        req = urllib.request.Request(
            f"{self.address}/v1/event/stream?{qs}",
            headers={**({"X-Nomad-Token": self.token}
                        if self.token else {})})
        resp = urllib.request.urlopen(req, context=self._ssl_ctx)
        try:
            for line in resp:
                line = line.strip()
                if not line or line == b"{}":
                    continue           # heartbeat
                yield json.loads(line)
        finally:
            resp.close()

    def events(self, index: int = 0) -> List[dict]:
        return self.get("/v1/event/stream", index=index, poll="true")

    def request_raw(self, method: str, path: str,
                    data: Optional[bytes] = None,
                    content_type: str = "application/octet-stream"
                    ) -> bytes:
        """request() with a binary body and a binary reply."""
        req = urllib.request.Request(
            f"{self.address}{path}", method=method, data=data,
            headers={**({"Content-Type": content_type}
                        if data is not None else {}),
                     **({"X-Nomad-Token": self.token}
                        if self.token else {})})
        return self._do(req)

    def snapshot_save(self) -> bytes:
        """(upstream: api/operator.go SnapshotSave) The archive's bytes."""
        return self.request_raw("GET", "/v1/operator/snapshot")

    def snapshot_restore(self, data: bytes) -> dict:
        return json.loads(
            self.request_raw("POST", "/v1/operator/snapshot", data)
            or b"null")


class HttpServerConn:
    """Node-agent transport over the HTTP API (the remote deployment
    shape; upstream: client->server msgpack RPC, nomad/client_rpc.go).
    Its calls are the node agent's side of the server: register,
    heartbeat, pull allocs (a blocking query), update allocs, register
    services, get an alloc. With ACLs on its token needs node:write."""

    def __init__(self, address: str = "http://127.0.0.1:4646",
                 timeout: float = 10.0, token: str = ""):
        import os
        # agents take their token from config or NOMAD_TOKEN, as
        # upstream's client does
        self.api = ApiClient(address, timeout=timeout,
                             token=token or os.environ.get("NOMAD_TOKEN",
                                                           ""))

    def register_node(self, node: Node) -> None:
        self.api.post("/v1/node/register", {"node": codec.encode(node)})

    def heartbeat(self, node_id: str) -> float:
        try:
            reply = self.api.post(f"/v1/node/{node_id}/heartbeat")
        except ApiError as e:
            if e.status == 404:     # unknown node: caller must re-register
                return 0.0
            raise
        return float(reply.get("heartbeat_ttl", 0.0))

    def pull_allocs(self, node_id: str, min_index: int,
                    timeout: float) -> tuple:
        reply = self.api.request(
            "GET", f"/v1/node/{node_id}/allocations",
            params={"index": min_index, "wait": f"{timeout}s"},
            timeout=timeout + 5.0)
        allocs = codec.decode(List[Allocation], reply.get("allocs", []))
        return allocs, int(reply.get("index", min_index))

    def update_allocs(self, updates: List[Allocation]) -> None:
        self.api.post("/v1/node/allocs-update",
                      {"allocs": [codec.encode(a) for a in updates]})

    def register_services(self, regs) -> None:
        self.api.post("/v1/node/services-register",
                      {"services": [codec.encode(r) for r in regs]})

    def get_alloc(self, alloc_id: str) -> Optional[Allocation]:
        try:
            data = self.api.get(f"/v1/allocation/{alloc_id}")
        except ApiError as e:
            if e.status == 404:
                return None
            raise
        return codec.decode(Allocation, data)
