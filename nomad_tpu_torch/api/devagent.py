"""Dev agent: one process with the port's Server, a simulated fleet and
the HTTP API (port of nomad_tpu/api/devagent.py; upstream: `nomad agent
-dev`, command/agent/command.go:775).

Run: python -m nomad_tpu_torch.api.devagent [--nodes N] [--port P]
     [--tpu] [--device cuda|cpu] [--config FILE]

``--device`` (default ``cuda``) is where the scheduler's placement
service and barriers dispatch; without a card the agent exits non-zero
with the reason. ``--device cpu`` runs the kernels' plain versions.
``--tpu`` selects the tpu-binpack algorithm (the kernels' path);
``--port 0`` binds a free port, printed in the ``==> nomad-tpu dev
agent: <address>`` line. SIGTERM or SIGINT ends the agent with exit 0.
"""
from __future__ import annotations

import argparse
import signal
import sys
import time


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="nomad-tpu-torch dev agent")
    parser.add_argument("--nodes", type=int, default=3,
                        help="simulated client nodes")
    parser.add_argument("--port", type=int, default=4646)
    parser.add_argument("--workers", type=int, default=2)
    parser.add_argument("--tpu", action="store_true",
                        help="select the tpu-binpack scheduler algorithm")
    parser.add_argument("--device", default="cuda",
                        help="where placements dispatch: cuda (default) "
                             "or cpu (the plain versions)")
    parser.add_argument("--region", default="global")
    parser.add_argument("--config", default="",
                        help="HCL agent config file (api/config.py); "
                             "flags override its values")
    parser.add_argument("--eval-batching", action="store_true",
                        dest="eval_batching",
                        help="coalesce evals into fused dispatches")
    parser.add_argument("--batch-width", type=int, default=0,
                        dest="batch_width")
    parser.add_argument("--datacenter", default="dc1")
    # the config file supplies defaults; flags passed explicitly win
    pre, _ = parser.parse_known_args(argv)
    tls_cfg = None
    file_cfg = None
    if pre.config:
        from .config import load_agent_config
        file_cfg = load_agent_config(pre.config)
        parser.set_defaults(
            region=file_cfg.region,
            datacenter=file_cfg.datacenter,
            port=file_cfg.http_port,
            workers=file_cfg.server.workers,
            eval_batching=file_cfg.server.eval_batching,
            batch_width=file_cfg.server.batch_width,
            nodes=(file_cfg.client.simulated_nodes
                   if file_cfg.client.enabled else 0),
            tpu=(file_cfg.server.scheduler_algorithm
                 in ("tpu-binpack", "tpu-spread")))
        if file_cfg.tls.any:
            tls_cfg = file_cfg.tls
    args = parser.parse_args(argv)

    from .. import mock
    from ..client import SimClient
    from ..device import resolve_device
    from ..server import Server
    from ..structs import SCHED_ALG_TPU_BINPACK, SchedulerConfiguration
    from .http import HttpServer

    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"==> nomad-tpu dev agent: {e}", file=sys.stderr)
        return 1
    server = Server(num_workers=args.workers,
                    eval_batching=args.eval_batching,
                    batch_width=args.batch_width or None, device=device)
    server.region = args.region
    if args.tpu:
        server.state.set_scheduler_config(SchedulerConfiguration(
            scheduler_algorithm=SCHED_ALG_TPU_BINPACK))
    server.start()

    scheme = ("https" if tls_cfg is not None and tls_cfg.enable_http
              else "http")
    http = HttpServer(server, port=args.port, tls=tls_cfg)
    http.start()
    clients = []
    for _ in range(args.nodes):
        c = SimClient(server, mock.node(datacenter=args.datacenter))
        c.start()
        clients.append(c)
    statsd = None
    if file_cfg is not None and file_cfg.telemetry.statsd_address:
        from ..server.telemetry import StatsdSink, metrics
        statsd = StatsdSink(file_cfg.telemetry.statsd_address, metrics,
                            interval_s=file_cfg.telemetry.interval_s)
        statsd.start()
        print(f"==> statsd sink: {file_cfg.telemetry.statsd_address}")
    print(f"==> nomad-tpu dev agent: {scheme}://127.0.0.1:{http.port} "
          f"({args.nodes} simulated nodes, "
          f"algorithm={server.state.scheduler_config().scheduler_algorithm}"
          f", device={device})", flush=True)

    # a flag, not an Event: a handler that sets an Event can deadlock
    # on the lock the main thread holds inside Event.wait
    stop = []
    signal.signal(signal.SIGINT, lambda *a: stop.append(1))
    signal.signal(signal.SIGTERM, lambda *a: stop.append(1))
    try:
        while not stop:
            time.sleep(0.2)
    finally:
        if statsd is not None:
            statsd.shutdown()
        http.shutdown()
        for c in clients:
            c.stop()
        server.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
