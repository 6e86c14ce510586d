"""Agent configuration files (port of nomad_tpu/api/config.py;
upstream: command/agent/config_parse.go and config.go's defaults and
merge): an HCL file parsed with the jobspec's HCL parser into defaults
that the dev agent's command-line flags override.

The surface:

    region       = "global"
    datacenter   = "dc1"
    ports        { http = 4646 }
    server       { enabled = true  workers = 4  eval_batching = true
                   batch_width = 8  acl_enabled = false
                   scheduler_algorithm = "tpu-binpack" }
    client       { enabled = true  simulated_nodes = 3 }
    tls          { http = true  ca_file = "..."
                   cert_file = "..."  key_file = "..." }
    telemetry    { statsd_address = "127.0.0.1:8125"  interval = 1 }

(/v1/metrics?format=prometheus needs no config.) The dev agent runs
simulated clients only, so the reference's ``real_clients`` and
``data_dir`` keys are not read.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict

from ..jobspec.hcl import parse_hcl
from ..tlsutil import TLSConfig


@dataclass
class ServerConfig:
    enabled: bool = True
    workers: int = 2
    eval_batching: bool = False
    batch_width: int = 0
    acl_enabled: bool = False
    scheduler_algorithm: str = ""


@dataclass
class ClientConfig:
    enabled: bool = True
    simulated_nodes: int = 3


@dataclass
class TelemetryConfig:
    """(upstream: the telemetry {} agent block, its sinks wired at
    command/agent/command.go:1164)"""

    statsd_address: str = ""
    interval_s: float = 1.0


@dataclass
class AgentConfig:
    region: str = "global"
    datacenter: str = "dc1"
    http_port: int = 4646
    server: ServerConfig = field(default_factory=ServerConfig)
    client: ClientConfig = field(default_factory=ClientConfig)
    tls: TLSConfig = field(default_factory=TLSConfig)
    telemetry: TelemetryConfig = field(default_factory=TelemetryConfig)


def _apply(obj, attrs: Dict[str, Any], mapping: Dict[str, str]) -> None:
    for key, attr in mapping.items():
        if key in attrs:
            setattr(obj, attr, attrs[key])


def parse_agent_config(src: str) -> AgentConfig:
    """Parse one agent config document. Raises HclError/ValueError on
    malformed input (admission-style: bad config must not half-apply)."""
    root = parse_hcl(src)
    cfg = AgentConfig()
    attrs = root.attrs()
    _apply(cfg, attrs, {"region": "region", "datacenter": "datacenter"})

    ports = root.first("ports")
    if ports is not None:
        p = ports.attrs()
        if "http" in p:
            cfg.http_port = int(p["http"])

    srv = root.first("server")
    if srv is not None:
        a = srv.attrs()
        _apply(cfg.server, a, {
            "enabled": "enabled", "workers": "workers",
            "eval_batching": "eval_batching", "batch_width": "batch_width",
            "acl_enabled": "acl_enabled",
            "scheduler_algorithm": "scheduler_algorithm"})
        cfg.server.workers = int(cfg.server.workers)
        cfg.server.batch_width = int(cfg.server.batch_width)

    cli = root.first("client")
    if cli is not None:
        a = cli.attrs()
        _apply(cfg.client, a, {
            "enabled": "enabled", "simulated_nodes": "simulated_nodes"})
        cfg.client.simulated_nodes = int(cfg.client.simulated_nodes)

    tel = root.first("telemetry")
    if tel is not None:
        a = tel.attrs()
        _apply(cfg.telemetry, a, {"statsd_address": "statsd_address",
                                  "interval": "interval_s"})
        cfg.telemetry.interval_s = float(cfg.telemetry.interval_s)

    tls = root.first("tls")
    if tls is not None:
        a = tls.attrs()
        _apply(cfg.tls, a, {
            "http": "enable_http", "rpc": "enable_rpc",
            "ca_file": "ca_file", "cert_file": "cert_file",
            "key_file": "key_file", "verify_incoming": "verify_incoming"})
        if cfg.tls.any and (not cfg.tls.cert_file or not cfg.tls.key_file):
            raise ValueError("tls block requires cert_file and key_file")
    return cfg


def load_agent_config(path: str) -> AgentConfig:
    with open(path, encoding="utf-8") as fh:
        return parse_agent_config(fh.read())
