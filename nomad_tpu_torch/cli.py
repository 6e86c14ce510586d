"""Operator CLI: ``python -m nomad_tpu_torch.cli <command> ...`` (port
of nomad_tpu/cli.py; upstream: command/, main.go:26). It talks to the
agent's HTTP API through api/client.py ApiClient, as upstream's CLI rides
its api/ module.

Commands: agent; job run|plan|status|stop|inspect|history|revert|
dispatch|scale; node status|drain|eligibility|purge; alloc status|stop;
eval; deployment [list|promote|pause|resume|fail]; operator scheduler;
operator snapshot save|restore; operator solver status|reprobe; operator
node flaps; operator workers; operator evals quarantine; operator
lockcheck|jitcheck|statecheck|schedcheck|sanitizers; operator
transfers|trace|quality; system gc; metrics; version. ``job plan``
exits 1 when a group would fail placement. ``schedcheck --replay`` /
``--explore`` run the port's own scenarios locally. The reference's
commands over layers the port's server lacks (variables, ACLs,
namespaces, node pools, services, CSI, keyring, raft, members, monitor,
debug bundles, alloc fs/logs/exec, the prefix search of ``status``) are
not here.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from .api.client import ApiClient, ApiError


def _fmt_table(rows: List[List[str]], headers: List[str]) -> str:
    cols = [headers] + [[str(c) for c in r] for r in rows]
    widths = [max(len(r[i]) for r in cols) for i in range(len(headers))]
    lines = ["  ".join(h.ljust(w) for h, w in zip(headers, widths))]
    for r in rows:
        lines.append("  ".join(str(c).ljust(w)
                               for c, w in zip(r, widths)))
    return "\n".join(lines)


def _client(args) -> ApiClient:
    addr = args.address or os.environ.get("NOMAD_ADDR",
                                          "http://127.0.0.1:4646")
    return ApiClient(addr, namespace=args.namespace,
                     token=os.environ.get("NOMAD_TOKEN", ""))


def _parse_vars(pairs: List[str]) -> dict:
    out = {}
    for p in pairs or []:
        if "=" not in p:
            raise SystemExit(f"bad -var {p!r}, want key=value")
        k, v = p.split("=", 1)
        out[k] = v
    return out


def cmd_agent(args) -> int:
    from .api.devagent import main as devagent_main
    argv = ["--nodes", str(args.nodes), "--port", str(args.port),
            "--workers", str(args.workers)]
    if args.tpu:
        argv.append("--tpu")
    argv += ["--device", args.device]
    return devagent_main(argv)


def cmd_job_run(args) -> int:
    api = _client(args)
    variables = _parse_vars(args.var)
    path = args.file
    with open(path, encoding="utf-8") as fh:
        src = fh.read()
    if path.endswith(".json"):
        reply = api.register_job(json.loads(src))
    else:
        reply = api.register_job_hcl(src, variables)
    print(f"==> Evaluation {reply.get('eval_id', '')!r} submitted")
    return 0


def cmd_job_plan(args) -> int:
    """(reference :72) The dry run's placements, stops and failed
    groups; exit 1 when a group would fail placement."""
    api = _client(args)
    with open(args.file, encoding="utf-8") as fh:
        src = fh.read()
    if args.file.endswith(".json"):
        job = json.loads(src)
        job = job.get("job", job)       # the wrapped shape too
        job_id = str(job.get("id", ""))
        if not job_id:
            print("Error: job spec has no 'id'", file=sys.stderr)
            return 1
        reply = api.plan_job(job_id, job=job)
    else:
        # the HCL itself: the server parses it with the full jobspec
        # mapper (devices, spreads and volumes survive it)
        job = api.parse_job(src, _parse_vars(args.var))
        job_id = job["id"]
        reply = api.plan_job(job_id, hcl=src,
                             variables=_parse_vars(args.var))
    print(f"+/- Job: {job_id!r} ({reply.get('diff_type')})")
    print(f"    placed: {reply.get('placed')}  "
          f"stopped: {reply.get('stopped')}")
    failed = reply.get("failed_tg_allocs") or {}
    for tg, metric in failed.items():
        print(f"    WARNING: group {tg!r} would fail placement: "
              f"{metric.get('nodes_evaluated', 0)} nodes evaluated, "
              f"{metric.get('nodes_filtered', 0)} filtered, "
              f"exhausted: {metric.get('dimension_exhausted', {})}")
    for tg, counts in (reply.get("annotations") or {}).get(
            "desired_tg_updates", {}).items():
        shown = {k: v for k, v in counts.items() if v}
        print(f"    group {tg!r}: {shown}")
    print(f"    job modify index: {reply.get('job_modify_index')}")
    return 1 if failed else 0


def cmd_job_status(args) -> int:
    api = _client(args)
    if not args.id:
        jobs = api.jobs()
        print(_fmt_table(
            [[j["id"], j["type"], str(j["priority"]), j["status"]]
             for j in jobs],
            ["ID", "Type", "Priority", "Status"]))
        return 0
    job = api.job(args.id)
    print(f"ID            = {job['id']}")
    print(f"Name          = {job['name']}")
    print(f"Type          = {job['type']}")
    print(f"Priority      = {job['priority']}")
    print(f"Status        = {job['status']}")
    print(f"Version       = {job['version']}")
    allocs = api.job_allocations(args.id)
    if allocs:
        print("\nAllocations")
        print(_fmt_table(
            [[a["id"][:8], a["task_group"], a["node_id"][:8],
              a["desired_status"], a["client_status"]] for a in allocs],
            ["ID", "Task Group", "Node", "Desired", "Status"]))
    return 0


def cmd_job_stop(args) -> int:
    api = _client(args)
    reply = api.deregister_job(args.id, purge=args.purge)
    print(f"==> Evaluation {reply.get('eval_id', '')!r} submitted")
    return 0


def cmd_job_inspect(args) -> int:
    print(json.dumps(_client(args).job(args.id), indent=2, default=str))
    return 0


def cmd_job_history(args) -> int:
    reply = _client(args).job_versions(args.id)
    rows = [[str(v["version"]), "true" if v.get("stable") else "false",
             v.get("status", "")] for v in reply.get("versions", [])]
    print(_fmt_table(rows, ["Version", "Stable", "Status"]))
    return 0


def cmd_job_revert(args) -> int:
    reply = _client(args).revert_job(args.id, args.version)
    print(f"==> Evaluation {reply.get('eval_id', '')!r} submitted")
    return 0


def cmd_job_dispatch(args) -> int:
    """(reference :161)"""
    payload = b""
    if args.payload_file:
        with open(args.payload_file, "rb") as f:
            payload = f.read()
    meta = dict(kv.split("=", 1) for kv in (args.meta or []))
    reply = _client(args).dispatch_job(args.id, payload, meta,
                                       args.idempotency_token)
    print(f"Dispatched Job ID = {reply.get('dispatched_job_id', '')}")
    print(f"Evaluation ID     = {reply.get('eval_id', '')}")
    return 0


def cmd_job_scale(args) -> int:
    """(reference :174)"""
    reply = _client(args).scale_job(args.id, args.group, args.count,
                                    message=args.message)
    print(f"==> Evaluation {reply.get('eval_id', '')!r} submitted")
    return 0


def cmd_node_status(args) -> int:
    api = _client(args)
    if not args.id:
        nodes = api.nodes()
        print(_fmt_table(
            [[n["id"][:8], n["name"], n["datacenter"], n["node_class"],
              "true" if n["drain"] else "false",
              n["scheduling_eligibility"], n["status"]] for n in nodes],
            ["ID", "Name", "DC", "Class", "Drain", "Eligibility",
             "Status"]))
        return 0
    n = api.node(args.id)
    print(json.dumps(n, indent=2, default=str))
    return 0


def cmd_node_drain(args) -> int:
    api = _client(args)
    api.drain_node(args.id, enable=args.enable,
                   deadline_s=args.deadline)
    print(f"Node {args.id!r} drain "
          f"{'enabled' if args.enable else 'disabled'}")
    return 0


def cmd_node_eligibility(args) -> int:
    api = _client(args)
    api.node_eligibility(args.id, eligible=args.enable)
    print(f"Node {args.id!r} marked "
          f"{'eligible' if args.enable else 'ineligible'}")
    return 0


def cmd_alloc_status(args) -> int:
    a = _client(args).allocation(args.id)
    print(f"ID         = {a['id']}")
    print(f"Name       = {a['name']}")
    print(f"Node       = {a['node_id']}")
    print(f"Job        = {a['job_id']}")
    print(f"Desired    = {a['desired_status']}")
    print(f"Status     = {a['client_status']}")
    metrics = a.get("metrics") or {}
    scores = metrics.get("scores") or {}
    if scores:
        print("\nPlacement Metrics")
        for key, score in sorted(scores.items())[:8]:
            print(f"  {key} = {score:.4f}"
                  if isinstance(score, float) else f"  {key} = {score}")
    return 0


def cmd_alloc_stop(args) -> int:
    """(upstream: command/alloc_stop.go)"""
    out = _client(args).post(f"/v1/allocation/{args.id}/stop")
    print(f"Stop requested; follow-up eval {out.get('eval_id')}")
    return 0


def cmd_node_purge(args) -> int:
    """(upstream: command/node_purge.go)"""
    _client(args).post(f"/v1/node/{args.id}/purge")
    print(f"Purged node {args.id}")
    return 0


def cmd_eval(args) -> int:
    api = _client(args)
    if args.id:
        print(json.dumps(api.evaluation(args.id), indent=2, default=str))
    else:
        evals = api.evaluations()
        print(_fmt_table(
            [[e["id"][:8], e["priority"], e["triggered_by"], e["job_id"],
              e["status"]] for e in evals],
            ["ID", "Priority", "Triggered By", "Job ID", "Status"]))
    return 0


def cmd_deployment_op(args) -> int:
    """(upstream: command/deployment_{promote,pause,resume,fail}.go)"""
    api = _client(args)
    if args.sub == "promote":
        body = {"groups": args.group} if args.group else None
        api.post(f"/v1/deployment/promote/{args.id}", body)
        print(f"Promoted deployment {args.id}"
              + (f" (groups: {', '.join(args.group)})" if args.group
                 else ""))
    elif args.sub == "pause":
        api.post(f"/v1/deployment/pause/{args.id}", {"pause": True})
        print(f"Paused deployment {args.id}")
    elif args.sub == "resume":
        api.post(f"/v1/deployment/pause/{args.id}", {"pause": False})
        print(f"Resumed deployment {args.id}")
    else:
        api.post(f"/v1/deployment/fail/{args.id}")
        print(f"Failed deployment {args.id}")
    return 0


def cmd_deployment(args) -> int:
    api = _client(args)
    deps = api.deployments()
    print(_fmt_table(
        [[d["id"][:8], d["job_id"], str(d["job_version"]), d["status"],
          d["status_description"]] for d in deps],
        ["ID", "Job ID", "Version", "Status", "Description"]))
    return 0


def cmd_operator_scheduler(args) -> int:
    api = _client(args)
    if args.algorithm:
        api.set_scheduler_config(scheduler_algorithm=args.algorithm,
                                 memory_oversubscription_enabled=args.memory_oversub)
        print(f"Scheduler algorithm set to {args.algorithm!r}")
    cfg = api.scheduler_config()
    print(json.dumps(cfg, indent=2, default=str))
    return 0


def cmd_operator_snapshot(args) -> int:
    """(reference :1515) Save the state into FILE, or restore it."""
    api = _client(args)
    if args.sub2 == "save":
        data = api.snapshot_save()
        with open(args.file, "wb") as f:
            f.write(data)
        print(f"Snapshot written to {args.file} ({len(data)} bytes)")
    else:
        with open(args.file, "rb") as f:
            reply = api.snapshot_restore(f.read())
        print(f"Snapshot restored (index {reply.get('index')})")
    return 0


def cmd_system_gc(args) -> int:
    print(json.dumps(_client(args).system_gc()))
    return 0


def cmd_metrics(args) -> int:
    print(json.dumps(_client(args).metrics(), indent=2, default=str))
    return 0


def cmd_operator_solver(args) -> int:
    """The dispatch guard's state and re-probe (rides /v1/agent/self
    stats.solver_guard and POST /v1/operator/solver/reprobe); the
    resident set is the port's counterpart of the const cache."""
    api = _client(args)
    if args.sub2 == "status":
        st = api.get("/v1/agent/self")["stats"]["solver_guard"]
        for k in ("checked", "ok", "degraded", "probe_timed_out",
                  "recovered_late", "host_fallback_dispatches",
                  "backend_unavailable_total", "recovered_total"):
            print(f"{k:28s} = {st.get(k)}")
        br = st.get("breaker") or {}
        for k in ("state", "consecutive_failures", "trips",
                  "recoveries", "backoff_s"):
            print(f"breaker.{k:20s} = {br.get(k)}")
        dis = st.get("dispatch") or {}
        for k in ("ok", "timeout", "error"):
            print(f"dispatch.{k:19s} = {dis.get(k)}")
        pipe = st.get("dispatch_pipeline") or {}
        for k in ("depth", "in_flight"):
            print(f"pipeline.{k:19s} = {pipe.get(k)}")
        me = st.get("mesh") or {}
        for k in ("enabled", "devices", "grid", "dispatches",
                  "lpq_dispatches"):
            print(f"mesh.{k:23s} = {me.get(k)}")
        cc = st.get("resident") or {}
        for k in ("enabled", "entries", "resident_bytes", "hits",
                  "misses", "bytes_saved_total", "invalidations",
                  "shard_entries", "shard_resident_bytes"):
            print(f"resident.{k:19s} = {cc.get(k)}")
        pc = st.get("pack_cache") or {}
        for k in ("enabled", "hits", "misses", "matrix_hits",
                  "matrix_misses", "usage_base_hits",
                  "usage_base_misses", "invalidations"):
            print(f"pack_cache.{k:17s} = {pc.get(k)}")
        ar = st.get("pack_arena") or {}
        for k in ("enabled", "entries", "in_use", "resident_bytes",
                  "reuses", "allocs", "evictions", "pad_fills_skipped"):
            print(f"pack_arena.{k:17s} = {ar.get(k)}")
        pk = st.get("pack") or {}
        ms = pk.get("ms") or {}
        print(f"pack.p50_ms              = {ms.get('p50_ms')}")
        print(f"pack.cache_hit           = {pk.get('cache_hit')}")
        print(f"pack.cache_miss          = {pk.get('cache_miss')}")
    elif args.sub2 == "reprobe":
        # a first-touch reprobe legitimately blocks for the in-process
        # probe deadline (<=30s) plus the subprocess transport probe
        api.timeout = 150.0
        rep = api.post("/v1/operator/solver/reprobe")
        print(f"recovered          = {rep.get('recovered')}")
        if rep.get("subprocess") is not None:
            sub = rep["subprocess"]
            print(f"transport probe    = "
                  f"{'TIMED OUT' if sub['timed_out'] else 'ok'} "
                  f"(devices={sub['devices']})")
        if rep.get("tunnel_ok_process_wedged"):
            print("verdict            = transport healthy but this "
                  "process is wedged: restart the agent to recover")
        print(f"guard ok           = {rep['state']['ok']}")
    return 0


def cmd_operator_node_flaps(args) -> int:
    """Flap-damping state (rides /v1/agent/self stats.node_flaps): per-
    node flap scores in the scoring window plus active quarantines --
    the `operator solver status` analog for the node lifecycle layer."""
    api = _client(args)
    st = api.get("/v1/agent/self")["stats"].get("node_flaps") or {}
    for k in ("enabled", "threshold", "window_s", "base_s", "max_s"):
        print(f"{k:12s} = {st.get(k)}")
    scores = st.get("scores") or {}
    quarantined = st.get("quarantined") or {}
    print(f"flapping     = {len(scores)} node(s)")
    for nid, score in sorted(scores.items(), key=lambda kv: -kv[1]):
        q = quarantined.get(nid)
        print(f"  {nid:38s} score={score:<4d}"
              + (f" quarantined {q:.1f}s" if q is not None else ""))
    for nid, rem in sorted(quarantined.items()):
        if nid not in scores:
            print(f"  {nid:38s} score=0    quarantined {rem:.1f}s")
    return 0


def cmd_operator_workers(args) -> int:
    """Supervised worker pool state (rides /v1/agent/self
    stats.worker_pool): per-slot liveness + progress-heartbeat age,
    and the supervisor's death/wedge/restart counters ."""
    api = _client(args)
    st = api.get("/v1/agent/self")["stats"].get("worker_pool") or {}
    for k in ("enabled", "stall_s", "restart_base_s", "restart_max_s",
              "restarts_total", "deaths_detected", "wedges_detected",
              "pending_restarts"):
        print(f"{k:16s} = {st.get(k)}")
    workers = st.get("workers") or []
    print(f"workers          = {len(workers)}")
    for w in workers:
        print(f"  {w['name']:28s} alive={str(w['alive']).lower():5s} "
              f"evals={w['evals_processed']:<8d} "
              f"progress_age={w['progress_age_s']:.1f}s")
    return 0


def cmd_operator_evals_quarantine(args) -> int:
    """Poison-eval dead-letter set (rides /v1/agent/self
    stats.eval_quarantine): evals that exhausted their delivery limit
    NOMAD_TPU_TORCH_POISON_AFTER times and were pulled from the retry loop.
    --release <id> / --release-all re-admit with a clean slate once
    the root cause is fixed ."""
    api = _client(args)
    if getattr(args, "release", None) or getattr(args, "release_all",
                                                 False):
        body = ({"release_all": True} if args.release_all
                else {"eval_id": args.release})
        out = api.post("/v1/operator/quarantine", body)
        released = out.get("released") or []
        print(f"released {len(released)} eval(s)")
        for eid in released:
            print(f"  {eid}")
        st = out.get("quarantine") or {}
    else:
        st = api.get("/v1/agent/self")["stats"].get(
            "eval_quarantine") or {}
    for k in ("poison_after", "delivery_limit", "total"):
        print(f"{k:14s} = {st.get(k)}")
    for rec in st.get("evals") or []:
        print(f"  {rec['id']:34s} job={rec['job_id']:20s} "
              f"type={rec['type']:8s} strikes={rec['strikes']:<3d} "
              f"age={rec['age_s']:.1f}s trigger={rec['triggered_by']}")
    return 0


def cmd_operator_lockcheck(args) -> int:
    """Lock-order sanitizer report (rides /v1/agent/self
    stats.lockcheck): acquisition-order cycles with both witness
    stacks, locks held across dispatch/fault-point/blocking waits, and
    escaped-frame bare acquires. Enable with NOMAD_TPU_TORCH_LOCKCHECK=1 on
    the agent; off is a true no-op and reports enabled=False."""
    api = _client(args)
    st = api.get("/v1/agent/self")["stats"].get("lockcheck") or {}
    for k in ("enabled", "wait_ms", "locks", "acquires", "edges",
              "edges_dropped", "reports_dropped", "cycle_count"):
        print(f"{k:15s} = {st.get(k)}")
    if not st.get("enabled") and not st.get("cycle_count"):
        print("(checker disabled: set NOMAD_TPU_TORCH_LOCKCHECK=1 on the "
              "agent to record lock orders)")
    for i, cyc in enumerate(st.get("cycles") or []):
        print(f"\nCYCLE {i}: potential deadlock over "
              f"{' -> '.join(cyc.get('locks') or [])}")
        for e in cyc.get("edges") or []:
            print(f"  edge {e.get('from')} -> {e.get('to')} "
                  f"[thread {e.get('thread')}]")
            if args.stacks:
                for ln in (e.get("stack") or "").rstrip().splitlines():
                    print(f"    {ln}")
    ha = st.get("held_across") or []
    if ha:
        print(f"\nheld-across violations: {len(ha)}")
        for v in ha:
            held = ", ".join(h.get("lock", "?")
                             for h in v.get("held") or [])
            det = f" ({v['detail']})" if v.get("detail") else ""
            print(f"  {v.get('kind')}{det} holding [{held}] "
                  f"[thread {v.get('thread')}]")
            if args.stacks:
                for ln in (v.get("stack") or "").rstrip().splitlines():
                    print(f"    {ln}")
    esc = st.get("escaped") or []
    if esc:
        print(f"\nescaped-frame bare acquires: {len(esc)}")
        for v in esc:
            print(f"  {v.get('lock')} acquired at "
                  f"{v.get('acquired_at')} in {v.get('in_function')}()"
                  f" [{v.get('reason')}, thread {v.get('thread')}]")
    return 1 if st.get("cycle_count") else 0


def cmd_operator_jitcheck(args) -> int:
    """Dispatch-discipline sanitizer report (rides /v1/agent/self
    stats.jitcheck): kernel rebuilds and builds past steady state with
    their signatures, hot-path host syncs by site, dtype drift and
    cache mutations. Enable with NOMAD_TPU_TORCH_JITCHECK=1 on the
    agent; off, it reports enabled=False. Exit 1 when steady-state
    rebuilds exist (the port's counterpart of the reference's
    retraces)."""
    api = _client(args)
    st = api.get("/v1/agent/self")["stats"].get("jitcheck") or {}
    for k in ("enabled", "launches", "builds", "site_count",
              "rebuild_count", "late_build_count", "host_sync_count",
              "sanctioned_fetches", "cuda_sync_warnings",
              "x64_leak_count", "mutation_count", "reports_dropped"):
        print(f"{k:20s} = {st.get(k)}")
    if not st.get("enabled") and not st.get("rebuild_count"):
        print("(checker disabled: set NOMAD_TPU_TORCH_JITCHECK=1 on the "
              "agent to account builds and syncs)")
    if args.sites:
        for s in st.get("sites") or []:
            print(f"  site {s.get('site'):42s}"
                  f" launches={s.get('launches'):<6d}"
                  f" builds={s.get('builds'):<4d}"
                  f" sigs={s.get('sigs'):<4d}"
                  f" steady={s.get('steady')}"
                  f" host_setup_repeats={s.get('host_setup_repeats')}")
    for i, r in enumerate(st.get("rebuilds") or []):
        print(f"\nREBUILD {i}: {r.get('site')} built "
              f"{r.get('count')}x for one signature "
              f"{r.get('signature')} [thread {r.get('thread')}]")
    for r in st.get("late_builds") or []:
        print(f"late build (report-only): {r.get('site')} "
              f"new sig {r.get('signature')} after steady state")
    for r in st.get("host_syncs") or []:
        print(f"hot-path host sync: {r.get('kind')} at {r.get('site')} "
              f"x{r.get('count')} (dispatch {r.get('label')!r}, "
              f"evals {r.get('evals')})")
    for r in st.get("dtype_drift") or []:
        print(f"dtype drift: {r.get('kind')} at {r.get('site')} "
              f"({r.get('where')}, {r.get('leaves')} leaves)")
    for r in st.get("mutations") or []:
        print(f"cache mutation: {r.get('kind')} at {r.get('site')} -- "
              f"{r.get('detail')}")
    return 1 if st.get("rebuild_count") else 0


def cmd_operator_statecheck(args) -> int:
    """MVCC snapshot-isolation sanitizer report (rides /v1/agent/self
    stats.statecheck): torn snapshot reads and aliasing writes with
    witness stacks, delta-journal coverage gaps, write-skew witnesses
    and stale version-keyed memos. Enable with NOMAD_TPU_TORCH_STATECHECK=1
    on the agent; off is a true no-op and reports enabled=False. Exit
    1 when torn reads or aliasing writes exist."""
    api = _client(args)
    st = api.get("/v1/agent/self")["stats"].get("statecheck") or {}
    for k in ("enabled", "reads", "mutations", "scopes",
              "journal_writes", "batch_commits", "memo_serves",
              "published_arrays", "registered_rows",
              "torn_read_count", "aliasing_write_count",
              "journal_gap_count", "write_skew_count",
              "stale_memo_count", "drift_count", "reports_dropped"):
        print(f"{k:20s} = {st.get(k)}")
    if not st.get("enabled") and not st.get("torn_read_count"):
        print("(checker disabled: set NOMAD_TPU_TORCH_STATECHECK=1 on the "
              "agent to record store discipline)")
    for i, r in enumerate(st.get("torn_reads") or []):
        print(f"\nTORN READ {i}: {r.get('kind')} in {r.get('op')} at "
              f"{r.get('site')} versions {r.get('versions')} "
              f"(evals {r.get('evals')}, thread {r.get('thread')})")
        if args.stacks:
            for ln in (r.get("stack") or "").rstrip().splitlines():
                print(f"    {ln}")
    for i, r in enumerate(st.get("aliasing_writes") or []):
        print(f"\nALIASING WRITE {i}: {r.get('kind')} at "
              f"{r.get('site')} -- {r.get('detail')} "
              f"[thread {r.get('thread')}]")
        if args.stacks:
            for ln in (r.get("stack") or "").rstrip().splitlines():
                print(f"    {ln}")
    for r in st.get("journal_gaps") or []:
        print(f"journal gap (report-only): delta-less allocs write at "
              f"{r.get('site')} (tables {r.get('tables')})")
    for r in st.get("write_skews") or []:
        print(f"write skew (report-only): node {r.get('node')} touched "
              f"by plans {r.get('plans')} in ONE batch commit")
    for r in st.get("stale_memos") or []:
        print(f"stale memo: {r.get('kind')} at {r.get('site')} entry "
              f"v{r.get('entry_version')} vs live "
              f"v{r.get('live_version')}")
    for r in st.get("drifts") or []:
        print(f"snapshot drift (designed, report-only): {r.get('op')} "
              f"at {r.get('site')} versions {r.get('versions')}")
    return 1 if (st.get("torn_read_count")
                 or st.get("aliasing_write_count")) else 0


def cmd_operator_schedcheck(args) -> int:
    """Deterministic schedule explorer (rides /v1/agent/self
    stats.schedcheck): run/seed/policy state, decision counters, and
    the deadlock/divergence counterexamples.  ``--replay SEED``
    re-runs a built-in scenario under the exact recorded interleaving
    LOCALLY (no agent round-trip) with lockcheck+statecheck armed;
    ``--explore N`` sweeps N seeds.  Exit 1 when violations (or agent
    deadlock reports) exist."""
    from . import schedcheck

    def _print_run(res) -> int:
        print(f"seed         = {res.seed}")
        print(f"policy       = {res.policy}")
        print(f"decisions    = {res.decisions}")
        print(f"fingerprint  = {res.fingerprint}")
        if res.error is not None:
            print(f"error        = {res.error!r}")
        print(f"violations   = {len(res.violations)}")
        for v in res.violations:
            sched = v.get("schedule") or {}
            at = (f" @ step {sched.get('step')}"
                  if sched.get("step") is not None else "")
            detail = " ".join(
                f"{k}={v[k]}" for k in ("op", "site", "node", "plans",
                                        "versions", "locks")
                if v.get(k) is not None)
            print(f"  [{v['checker']}] {v['kind']}{at} {detail}")
        return 1 if res.violations else 0

    if args.replay is not None:
        fn = schedcheck.SCENARIOS.get(args.scenario)
        if fn is None:
            print(f"unknown scenario {args.scenario!r} (have: "
                  f"{', '.join(sorted(schedcheck.SCENARIOS))})")
            return 2
        res = schedcheck.replay(fn, args.replay, policy=args.policy)
        return _print_run(res)
    if args.explore is not None:
        fn = schedcheck.SCENARIOS.get(args.scenario)
        if fn is None:
            print(f"unknown scenario {args.scenario!r} (have: "
                  f"{', '.join(sorted(schedcheck.SCENARIOS))})")
            return 2
        agg = schedcheck.explore(fn, seeds=args.explore,
                                 policy=args.policy)
        print(f"explored     = {len(agg.runs)} schedules "
              f"(scenario {args.scenario})")
        print(f"violations   = {len(agg.violations)} across seeds "
              f"{agg.seeds_with_violations}")
        for r in agg.runs:
            if r.violations:
                print(f"--- seed {r.seed} "
                      f"(replay: operator schedcheck --replay {r.seed} "
                      f"--scenario {args.scenario})")
                _print_run(r)
        return 1 if agg.violations else 0
    api = _client(args)
    st = api.get("/v1/agent/self")["stats"].get("schedcheck") or {}
    for k in ("enabled", "run_active", "seed", "policy", "depth",
              "park_s", "runs", "decisions", "parks", "preemptions",
              "timeout_wakes", "deadlock_count", "divergence_count",
              "threads_managed", "reports_dropped"):
        print(f"{k:16s} = {st.get(k)}")
    if not st.get("enabled") and not st.get("deadlock_count"):
        print("(checker disabled: set NOMAD_TPU_TORCH_SCHEDCHECK=1 on the "
              "agent to control schedules)")
    lr = st.get("last_run") or {}
    if lr:
        print(f"last run: seed={lr.get('seed')} "
              f"policy={lr.get('policy')} "
              f"decisions={lr.get('decisions')} "
              f"fingerprint={lr.get('fingerprint')}")
    for r in st.get("reports") or []:
        if r.get("kind") == "deadlock":
            waiting = ", ".join(
                f"{w.get('thread')} on {w.get('on')}"
                for w in r.get("waiting") or [])
            print(f"\nDEADLOCK @ seed {r.get('schedule_seed')} step "
                  f"{r.get('step')} ({r.get('policy')}): [{waiting}]")
            print(f"  replay: operator schedcheck --replay "
                  f"{r.get('schedule_seed')}")
        else:
            print(f"\nDIVERGENCE @ seed {r.get('schedule_seed')}: "
                  f"expected {r.get('expected')} got {r.get('got')} "
                  f"(the scenario changed between record and replay)")
    return 1 if (st.get("deadlock_count")
                 or st.get("divergence_count")) else 0


def cmd_operator_sanitizers(args) -> int:
    """One-table summary of the four sanitizers (lockcheck, jitcheck,
    statecheck, schedcheck) off /v1/agent/self. Exit 1 when a hard
    violation class is non-zero (cycles, steady-state rebuilds, torn
    reads, aliasing writes, manifested deadlocks, divergences)."""
    api = _client(args)
    stats = api.get("/v1/agent/self")["stats"]
    lc = stats.get("lockcheck") or {}
    jc = stats.get("jitcheck") or {}
    sc = stats.get("statecheck") or {}
    dc = stats.get("schedcheck") or {}
    rows = [
        ("lockcheck", lc.get("enabled"),
         {"cycles": lc.get("cycle_count", 0),
          "held_across": len(lc.get("held_across") or []),
          "escaped": len(lc.get("escaped") or [])},
         ("cycles",)),
        ("jitcheck", jc.get("enabled"),
         {"rebuilds": jc.get("rebuild_count", 0),
          "host_syncs": jc.get("host_sync_count", 0),
          "x64_leaks": jc.get("x64_leak_count", 0),
          "mutations": jc.get("mutation_count", 0)},
         ("rebuilds",)),
        ("statecheck", sc.get("enabled"),
         {"torn_reads": sc.get("torn_read_count", 0),
          "aliasing": sc.get("aliasing_write_count", 0),
          "journal_gaps": sc.get("journal_gap_count", 0),
          "write_skews": sc.get("write_skew_count", 0),
          "stale_memos": sc.get("stale_memo_count", 0)},
         ("torn_reads", "aliasing")),
        ("schedcheck", dc.get("enabled"),
         {"deadlocks": dc.get("deadlock_count", 0),
          "divergences": dc.get("divergence_count", 0),
          "preemptions": dc.get("preemptions", 0)},
         ("deadlocks", "divergences")),
    ]
    rc = 0
    print(f"{'sanitizer':12s} {'enabled':8s} {'verdict':8s} findings")
    for name, enabled, counts, hard in rows:
        bad = any(counts.get(k) for k in hard)
        soft = any(v for v in counts.values())
        verdict = ("FAIL" if bad else
                   "warn" if soft else
                   "clean" if enabled else "off")
        if bad:
            rc = 1
        detail = " ".join(f"{k}={v}" for k, v in counts.items())
        print(f"{name:12s} {str(bool(enabled)):8s} {verdict:8s} "
              f"{detail}")
    if rc == 0 and not any(r[1] for r in rows):
        print("(all sanitizers disabled: set NOMAD_TPU_TORCH_LOCKCHECK/"
              "JITCHECK/STATECHECK/SCHEDCHECK=1 to record)")
    return rc


def cmd_operator_transfers(args) -> int:
    """Transfer & device-residency observatory (rides /v1/agent/self
    stats.xferobs): the per-dispatch payload ledger decomposed by tree
    group (shipped vs cache-resident bytes), the sanctioned-fetch
    result-byte table, the const-cache residency map (per-entry
    bytes/version/age/hits + high watermark), and the live tunnel-model
    fit (rtt/bandwidth/crossover). Exit 1 when the ledger's byte parity
    against nomad.solver.dispatch_bytes_total is nonzero."""
    api = _client(args)
    st = api.get("/v1/agent/self")["stats"].get("xferobs") or {}
    if not st.get("enabled", False):
        print("transfer observatory disabled (NOMAD_TPU_TORCH_XFEROBS=0)")
        return 0

    def mb(n):
        return f"{(n or 0) / 1048576.0:.3f}"

    for k in ("dispatches", "shipped_bytes_total",
              "resident_bytes_total", "fetched_bytes_total",
              "counter_mirror_bytes", "parity_bytes"):
        print(f"{k:22s} = {st.get(k)}")
    groups = st.get("groups") or {}
    if groups:
        print()
        print(_fmt_table(
            [[g, mb(d["shipped_bytes"]), mb(d["resident_bytes"]),
              str(d["shipped_arrays"]), str(d["resident_arrays"])]
             for g, d in sorted(groups.items())],
            ["Group", "Shipped(MB)", "Resident(MB)", "Ships", "Hits"]))
    fetches = st.get("fetches") or {}
    if fetches:
        print()
        print(_fmt_table(
            [[g, mb(d["bytes"]), str(d["fetches"])]
             for g, d in sorted(fetches.items())],
            ["Fetch", "Bytes(MB)", "Count"]))
    fit = st.get("tunnel")
    print()
    if fit:
        bw = fit.get("bw_mbps")
        xo = fit.get("crossover_bytes")
        # a local (in-process CPU fallback) backend has no tunnel to
        # fit: bandwidth is structurally absent, not merely unsampled
        bw_txt = (f"{bw}MB/s" if bw is not None
                  else "n/a (local backend)")
        print(f"tunnel fit: rtt={fit.get('rtt_ms')}ms "
              f"bw={bw_txt} "
              f"samples={fit.get('samples')} "
              f"residual={fit.get('residual_rms_ms')}ms"
              + (f" crossover={xo}B" if xo is not None else "")
              + (f" (skipped {fit.get('skipped_slow')} compile-slow)"
                 if fit.get("skipped_slow") else ""))
    else:
        print("tunnel fit: insufficient samples")
    res = st.get("residency") or {}
    if res:
        print(f"residency: {res.get('entries')} pinned entries, "
              f"{mb(res.get('resident_bytes'))}MB resident "
              f"(hwm {mb(res.get('resident_hwm_bytes'))}MB, "
              f"{res.get('evictions')} evictions, "
              f"{res.get('invalidations')} invalidations)")
        if res.get("chain_entries"):
            print(f"delta chain: {res.get('chain_entries')} entries, "
                  f"{mb(res.get('chain_resident_bytes'))}MB resident, "
                  f"{res.get('delta_promotions')} promotions / "
                  f"{res.get('delta_reuses')} reuses / "
                  f"{res.get('delta_fallbacks')} fallbacks, "
                  f"{mb(res.get('delta_bytes_total'))}MB delta payload")
        top = res.get("top") or []
        if top:
            # chain rows promote in place: show the base version the
            # device buffer was installed at and how many journal
            # deltas have been applied since
            def chain_col(e):
                if "base_version" in e:
                    return (f"v{e['base_version']}"
                            f"+{e.get('deltas_applied', 0)}d")
                return ""
            print(_fmt_table(
                [[e["id"], mb(e["bytes"]), str(e.get("version")),
                  chain_col(e), f"{e['age_s']:.0f}", str(e["hits"])]
                 for e in top],
                ["Entry", "MB", "Version", "Chain", "Age(s)", "Hits"]))
    return 1 if st.get("parity_bytes") else 0


def _render_trace_waterfall(tr: dict, width: int = 48) -> str:
    """ASCII span waterfall for one eval trace: each span a bar
    positioned/scaled on the trace's wall-clock extent."""
    lines = []
    flag = (f"  DEGRADED({tr.get('degraded_reason')})"
            if tr.get("degraded") else "")
    lines.append(f"Eval      {tr.get('eval_id')}")
    lines.append(f"Status    {tr.get('status')}"
                 f"  dur={tr.get('dur_ms', 0.0):.2f}ms{flag}")
    tags = tr.get("tags") or {}
    if tags:
        lines.append("Tags      " + " ".join(
            f"{k}={v}" for k, v in sorted(tags.items())))
    if tr.get("error"):
        lines.append(f"Error     {tr['error']}")
    spans = tr.get("spans") or []
    if not spans:
        lines.append("(no spans recorded)")
        return "\n".join(lines)
    t0 = min(s["t0"] for s in spans)
    t1 = max(s["t0"] + s["dur_ms"] / 1e3 for s in spans)
    total = max(t1 - t0, 1e-9)
    lines.append("")
    name_w = min(28, max(len(s["name"]) for s in spans) + 1)
    for s in sorted(spans, key=lambda s: (s["t0"], -s["dur_ms"])):
        off = int((s["t0"] - t0) / total * width)
        off = min(off, width - 1)
        ln = max(1, round(s["dur_ms"] / 1e3 / total * width))
        bar = (" " * off + "▇" * min(ln, width - off)).ljust(width)
        stags = " ".join(f"{k}={v}"
                         for k, v in sorted(
                             (s.get("tags") or {}).items()))
        lines.append(f"  {s['name']:<{name_w}} |{bar}| "
                     f"{s['dur_ms']:>9.2f}ms  {stags}".rstrip())
    if tr.get("truncated_spans"):
        lines.append(f"  ... {tr['truncated_spans']} spans truncated "
                     "(NOMAD_TPU_TORCH_TRACE_MAX_SPANS)")
    return "\n".join(lines)


def cmd_operator_trace(args) -> int:
    """Eval trace forensics (rides GET /v1/agent/trace): fetch one
    eval's span waterfall, or list/render the slowest or degraded
    retained traces."""
    api = _client(args)
    if args.eval_id:
        try:
            tr = api.get(f"/v1/agent/trace/{args.eval_id}")
        except ApiError as e:
            print(f"No trace for eval {args.eval_id!r}: {e}",
                  file=sys.stderr)
            return 1
        print(_render_trace_waterfall(tr))
        if getattr(args, "quality", False):
            print()
            _print_quality_summary(api)
        return 0
    params = {}
    if args.degraded:
        params["degraded"] = "1"
    if args.slowest:
        params["slowest"] = str(args.slowest)
    reply = api.get("/v1/agent/trace", **params)
    traces = reply.get("traces", [])
    stats = reply.get("stats", {})
    if not traces:
        print("No retained traces"
              + ("" if stats.get("enabled", True)
                 else " (tracing disabled: NOMAD_TPU_TORCH_TRACE=0)")
              + f"; {stats.get('dropped', 0)} dropped/sampled out.")
        if getattr(args, "quality", False):
            print()
            _print_quality_summary(api)
        return 0
    print(_fmt_table(
        [[t["eval_id"][:16], t.get("tags", {}).get("lane", "-"),
          f"{t['dur_ms']:.1f}", str(t["spans"]),
          (t.get("degraded_reason") or
           ("error" if t.get("error") else "-")), t["status"]]
         for t in traces],
        ["Eval", "Lane", "Duration(ms)", "Spans", "Degraded",
         "Status"]))
    if args.slowest:
        # --slowest N renders each returned trace's waterfall in full
        for t in traces:
            try:
                full = api.get(f"/v1/agent/trace/{t['eval_id']}")
            except ApiError:
                continue
            print()
            print(_render_trace_waterfall(full))
    if getattr(args, "quality", False):
        # degraded-eval triage context: were the degraded evals also
        # DRIFTING (shadow audit), and which stage is saturated?
        print()
        _print_quality_summary(api)
    return 0


def _print_quality_summary(api) -> None:
    try:
        rep = api.get("/v1/operator/quality")
    except ApiError as e:
        print(f"(quality report unavailable: {e})")
        return
    if not rep.get("enabled"):
        print("quality observatory disabled (NOMAD_TPU_TORCH_QUALITY=0)")
        return
    a = rep.get("audit") or {}
    print(f"shadow audit   audited={a.get('audited', 0)} "
          f"drift_max={a.get('score_drift_max', 0.0)} "
          f"mismatches={a.get('decision_mismatch_total', 0)}"
          + (f"  ALERT({a['alert']['reason']})" if a.get("alert")
             else ""))
    sat = rep.get("saturation") or {}
    if sat.get("bottleneck"):
        b = sat["stages"][sat["bottleneck"]]
        print(f"bottleneck     {sat['bottleneck']} "
              f"(L={b['littles_l']}, busy={b['busy_pct']}%, "
              f"p99={b['p99_ms']}ms)")


def cmd_operator_quality(args) -> int:
    """Quality scoreboard + shadow-oracle audit + pipeline saturation
    attribution (rides GET /v1/operator/quality)."""
    api = _client(args)
    rep = api.get("/v1/operator/quality")
    if not rep.get("enabled"):
        print("quality observatory disabled (NOMAD_TPU_TORCH_QUALITY=0)")
        return 0
    p = rep.get("placement") or {}
    if not p.get("attached"):
        print("quality observatory not attached to a running server")
    else:
        fleet = p["fleet"]
        print(f"fleet          {fleet['nodes']} nodes "
              f"({fleet['ready']} ready, {fleet['occupied']} occupied), "
              f"{fleet['live_allocs']} live allocs")
        print(f"fragmentation  {p['fragmentation_index']}")
        pe = p["packing_efficiency"]
        print(f"packing_eff    cpu={pe['cpu']} mem={pe['mem']}")
        for dim in ("cpu", "mem"):
            u = p["utilization"][dim]
            bars = "".join(
                " .:-=+*#%@"[min(9, int(c * 9 / max(max(u["hist"]), 1)))]
                for c in u["hist"])
            print(f"util[{dim}]      mean={u['mean']} p50={u['p50']} "
                  f"p90={u['p90']} max={u['max']}  |{bars}| (0->1)")
        churn = p["churn"]
        print("churn          " + " ".join(
            f"{k}={churn[k]}" for k in
            ("placements", "stops", "preemptions", "reschedules",
             "completions", "failures", "rejected_nodes")))
        for name, s in sorted((p.get("scores") or {}).items()):
            print(f"score[{name}]  n={s['count']} "
                  f"mean={s['mean']:.4f} p50={s.get('p50', 0):.4f} "
                  f"p99={s.get('p99', 0):.4f}")
    _print_quality_summary(api)
    sat = rep.get("saturation") or {}
    stages = sat.get("stages") or {}
    if stages:
        print()
        print(_fmt_table(
            [[st, d["kind"], str(d["count"]), f"{d['mean_ms']:.2f}",
              f"{d['p99_ms']:.2f}", f"{d['busy_pct']:.2f}",
              f"{d['littles_l']:.3f}",
              f"{d['share_of_recorded_pct']:.1f}"]
             for st, d in sorted(stages.items())],
            ["Stage", "Kind", "Count", "Mean(ms)", "p99(ms)",
             "Busy%", "L", "Share%"]))
    return 0


def cmd_version(args) -> int:
    from .client.fingerprint import VERSION
    print(f"nomad-tpu v{VERSION} (tpu-native cluster scheduler)")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="nomad-tpu-torch")
    p.add_argument("-address", dest="address", default="")
    p.add_argument("-namespace", dest="namespace", default="default")
    sub = p.add_subparsers(dest="cmd", required=True)

    ag = sub.add_parser("agent", help="run the dev agent")
    ag.add_argument("-dev", action="store_true", default=True)
    ag.add_argument("--nodes", type=int, default=3)
    ag.add_argument("--port", type=int, default=4646)
    ag.add_argument("--workers", type=int, default=2)
    ag.add_argument("--tpu", action="store_true")
    ag.add_argument("--device", default="cuda")
    ag.set_defaults(fn=cmd_agent)

    job = sub.add_parser("job", help="job commands").add_subparsers(
        dest="sub", required=True)
    jr = job.add_parser("run")
    jr.add_argument("file")
    jr.add_argument("-var", action="append", default=[])
    jr.set_defaults(fn=cmd_job_run)
    jp = job.add_parser("plan")
    jp.add_argument("file")
    jp.add_argument("-var", action="append", default=[])
    jp.set_defaults(fn=cmd_job_plan)
    js = job.add_parser("status")
    js.add_argument("id", nargs="?", default="")
    js.set_defaults(fn=cmd_job_status)
    jst = job.add_parser("stop")
    jst.add_argument("id")
    jst.add_argument("-purge", action="store_true")
    jst.set_defaults(fn=cmd_job_stop)
    ji = job.add_parser("inspect")
    ji.add_argument("id")
    ji.set_defaults(fn=cmd_job_inspect)
    jh = job.add_parser("history")
    jh.add_argument("id")
    jh.set_defaults(fn=cmd_job_history)
    jrev = job.add_parser("revert")
    jrev.add_argument("id")
    jrev.add_argument("version", type=int)
    jrev.set_defaults(fn=cmd_job_revert)
    jd = job.add_parser("dispatch")
    jd.add_argument("id")
    jd.add_argument("payload_file", nargs="?", default="")
    jd.add_argument("-meta", action="append", default=[])
    jd.add_argument("-idempotency-token", dest="idempotency_token",
                    default="")
    jd.set_defaults(fn=cmd_job_dispatch)
    jsc = job.add_parser("scale")
    jsc.add_argument("id")
    jsc.add_argument("group")
    jsc.add_argument("count", type=int)
    jsc.add_argument("-message", default="")
    jsc.set_defaults(fn=cmd_job_scale)

    node = sub.add_parser("node", help="node commands").add_subparsers(
        dest="sub", required=True)
    ns = node.add_parser("status")
    ns.add_argument("id", nargs="?", default="")
    ns.set_defaults(fn=cmd_node_status)
    npg = node.add_parser("purge")
    npg.add_argument("id")
    npg.set_defaults(fn=cmd_node_purge)
    nd = node.add_parser("drain")
    nd.add_argument("id")
    g = nd.add_mutually_exclusive_group(required=True)
    g.add_argument("-enable", dest="enable", action="store_true")
    g.add_argument("-disable", dest="enable", action="store_false")
    nd.add_argument("-deadline", type=float, default=3600.0)
    nd.set_defaults(fn=cmd_node_drain)
    ne = node.add_parser("eligibility")
    ne.add_argument("id")
    g = ne.add_mutually_exclusive_group(required=True)
    g.add_argument("-enable", dest="enable", action="store_true")
    g.add_argument("-disable", dest="enable", action="store_false")
    ne.set_defaults(fn=cmd_node_eligibility)

    al = sub.add_parser("alloc", help="alloc commands").add_subparsers(
        dest="sub", required=True)
    als = al.add_parser("status")
    als.add_argument("id")
    als.set_defaults(fn=cmd_alloc_status)
    alst = al.add_parser("stop")
    alst.add_argument("id")
    alst.set_defaults(fn=cmd_alloc_stop)

    ev = sub.add_parser("eval", help="eval commands")
    ev.add_argument("id", nargs="?", default="")
    ev.set_defaults(fn=cmd_eval)

    dep = sub.add_parser("deployment", help="deployment commands")
    depsub = dep.add_subparsers(dest="sub")
    dep.set_defaults(fn=cmd_deployment)
    for op_name in ("promote", "pause", "resume", "fail"):
        dop = depsub.add_parser(op_name)
        if op_name == "promote":
            # (upstream: command/deployment_promote.go -group)
            dop.add_argument("-group", action="append", default=[])
        dop.add_argument("id")
        dop.set_defaults(fn=cmd_deployment_op)
    depls = depsub.add_parser("list")
    depls.set_defaults(fn=cmd_deployment)

    op = sub.add_parser("operator").add_subparsers(dest="sub",
                                                   required=True)
    osch = op.add_parser("scheduler")
    osch.add_argument("-scheduler-algorithm", dest="algorithm", default="")
    osch.add_argument("-memory-oversubscription", dest="memory_oversub",
                      action="store_true")
    osch.set_defaults(fn=cmd_operator_scheduler)
    osn = op.add_parser("snapshot").add_subparsers(dest="sub2",
                                                   required=True)
    for name in ("save", "restore"):
        osnx = osn.add_parser(name)
        osnx.add_argument("file")
        osnx.set_defaults(fn=cmd_operator_snapshot)
    osol = op.add_parser("solver").add_subparsers(dest="sub2",
                                                  required=True)
    osol.add_parser("status").set_defaults(fn=cmd_operator_solver)
    osol.add_parser("reprobe").set_defaults(fn=cmd_operator_solver)
    onode = op.add_parser("node").add_subparsers(dest="sub2",
                                                 required=True)
    onode.add_parser("flaps",
                     help="per-node flap scores + active quarantines"
                     ).set_defaults(fn=cmd_operator_node_flaps)
    op.add_parser("workers",
                  help="supervised scheduler worker pool state "
                  "(liveness, progress heartbeats, restarts)"
                  ).set_defaults(fn=cmd_operator_workers)
    oevals = op.add_parser("evals").add_subparsers(dest="sub2",
                                                   required=True)
    oq = oevals.add_parser("quarantine",
                           help="poison-eval dead letters; release "
                           "with --release <id> / --release-all")
    oq.add_argument("--release", metavar="EVAL_ID", default=None,
                    help="re-admit one quarantined eval")
    oq.add_argument("--release-all", action="store_true",
                    dest="release_all",
                    help="re-admit every quarantined eval")
    oq.set_defaults(fn=cmd_operator_evals_quarantine)
    olc = op.add_parser("lockcheck",
                        help="lock-order sanitizer report (cycles, "
                        "held-across, escaped-frame acquires)")
    olc.add_argument("--stacks", action="store_true",
                     help="print the witness stacks under each finding")
    olc.set_defaults(fn=cmd_operator_lockcheck)
    osc = op.add_parser("statecheck",
                        help="MVCC snapshot-isolation sanitizer report "
                        "(torn reads / aliasing writes / journal gaps "
                        "/ write skew / stale memos)")
    osc.add_argument("--stacks", action="store_true",
                     help="print witness stacks per finding")
    osc.set_defaults(fn=cmd_operator_statecheck)
    osan = op.add_parser("sanitizers",
                         help="one-table summary of lockcheck + "
                         "jitcheck + statecheck + schedcheck state")
    osan.set_defaults(fn=cmd_operator_sanitizers)
    odc = op.add_parser("schedcheck",
                        help="deterministic schedule explorer report, "
                        "seeded replay of a recorded interleaving, or "
                        "a local seed sweep")
    odc.add_argument("--replay", type=int, default=None, metavar="SEED",
                     help="re-run the scenario under this exact "
                     "schedule seed (local)")
    odc.add_argument("--explore", type=int, default=None, metavar="N",
                     help="sweep N schedule seeds locally and "
                     "aggregate violations")
    odc.add_argument("--scenario", default="broker-smoke",
                     help="built-in scenario for --replay/--explore "
                     "(broker-smoke, planted-write-skew, "
                     "planted-torn-read)")
    odc.add_argument("--policy", default=None,
                     help="schedule policy: random (default), pct, rr")
    odc.set_defaults(fn=cmd_operator_schedcheck)
    ojc = op.add_parser("jitcheck",
                        help="dispatch-discipline sanitizer report "
                        "(kernel rebuilds, hot-path host syncs, dtype "
                        "drift, cache mutations)")
    ojc.add_argument("--sites", action="store_true",
                     help="print the per-call-site table")
    ojc.set_defaults(fn=cmd_operator_jitcheck)
    otx = op.add_parser("transfers",
                        help="transfer ledger + device-residency map "
                        "+ transfer-model fit (xferobs)")
    otx.set_defaults(fn=cmd_operator_transfers)
    otr = op.add_parser("trace",
                        help="eval span-waterfall forensics")
    otr.add_argument("eval_id", nargs="?", default="")
    otr.add_argument("--slowest", type=int, default=0,
                     help="render the N slowest retained traces")
    otr.add_argument("--degraded", action="store_true",
                     help="only degraded/errored traces")
    otr.add_argument("--quality", action="store_true",
                     help="append the quality scoreboard / shadow-audit"
                     " context (drift, mismatches, bottleneck) below"
                     " the traces")
    otr.set_defaults(fn=cmd_operator_trace)
    oqa = op.add_parser("quality",
                        help="placement-quality scoreboard, shadow-"
                        "oracle audit + pipeline saturation report")
    oqa.set_defaults(fn=cmd_operator_quality)

    sysp = sub.add_parser("system").add_subparsers(dest="sub",
                                                   required=True)
    sg = sysp.add_parser("gc")
    sg.set_defaults(fn=cmd_system_gc)

    mt = sub.add_parser("metrics")
    mt.set_defaults(fn=cmd_metrics)

    vr = sub.add_parser("version")
    vr.set_defaults(fn=cmd_version)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except ApiError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    except (OSError, json.JSONDecodeError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
