"""TLS for the HTTP API (port of nomad_tpu/tlsutil.py; upstream:
helper/tlsutil and the agent's tls {} block, command/agent/config.go).

Mutual TLS: when a CA is configured, both sides verify their peer
against it (the upstream verify_incoming / verify_outgoing model).
"""
from __future__ import annotations

import ssl
from dataclasses import dataclass
from typing import Optional


@dataclass
class TLSConfig:
    """The agent's tls {} block (upstream: config.TLSConfig)."""

    enable_http: bool = False
    enable_rpc: bool = False
    ca_file: str = ""
    cert_file: str = ""
    key_file: str = ""
    verify_incoming: bool = True

    @property
    def any(self) -> bool:
        return self.enable_http or self.enable_rpc


def server_context(cfg: TLSConfig) -> ssl.SSLContext:
    """A listener's context: it presents the server certificate and,
    with a CA and verify_incoming, requires client certificates the CA
    signed."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(cfg.cert_file, cfg.key_file)
    if cfg.ca_file:
        ctx.load_verify_locations(cfg.ca_file)
        if cfg.verify_incoming:
            ctx.verify_mode = ssl.CERT_REQUIRED
    return ctx


def client_context(cfg: TLSConfig,
                   server_hostname: Optional[str] = None) -> ssl.SSLContext:
    """An outbound connection's context: it verifies the server against
    the configured CA and presents our certificate (mutual TLS). Without
    a CA the system trust store applies, with full hostname checks: no
    CA never means no verification."""
    if cfg.ca_file:
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        ctx.load_verify_locations(cfg.ca_file)
        # cluster-internal certificates carry fixed SANs, not host names
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_REQUIRED
    else:
        ctx = ssl.create_default_context()
    if cfg.cert_file:
        ctx.load_cert_chain(cfg.cert_file, cfg.key_file)
    return ctx
