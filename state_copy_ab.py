#!/usr/bin/env python3
"""Time the port's state copy -- state/restore.py ``restore_state`` and
``dump_state``, the copy every ``job plan`` makes -- under two versions
of nomad_tpu_torch/structs/codec.py, on one host, in alternating runs.

    python3 state_copy_ab.py [--nodes N] [--jobs J] [--allocs A]
                             [--pairs P] [--seed S] TAG=CODEC TAG=CODEC

The state (N mock nodes, J mock service jobs, A running allocs spread
over them round robin, as a loaded leader holds them; by default phase
18's 10,000 nodes and 25,100 allocs of chip_smoke.py) is built once from
the seed and dumped to JSON. Each run is a fresh interpreter that loads
that JSON, puts the named codec file's code in place of the package's
codec, restores the blob into a fresh store and dumps that store again,
and reports the two times (host clock, one restore and one dump). Each
dump must equal the blob: a codec that changes the output fails the
run. The P pairs alternate which side runs first. The report, one JSON
line: each side's runs, medians and quartiles, and how many pairs the
second side won on each time. Needs no card.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def build_blob(n_nodes: int, n_jobs: int, n_allocs: int, seed: int) -> dict:
    """The seeded state's dump_state blob."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.state.restore import dump_state
    from nomad_tpu_torch.state.store import StateStore
    from nomad_tpu_torch.structs import (
        AllocatedResources, AllocatedSharedResources, AllocatedTaskResources,
        Allocation, AllocMetric, generate_uuid, reseed_ids)

    reseed_ids(seed)
    store = StateStore()
    nodes = [mock.node() for _ in range(n_nodes)]
    for node in nodes:
        store.upsert_node(node)
    jobs = []
    for j in range(n_jobs):
        job = mock.job(id=f"copy-{j}")
        job.task_groups[0].count = -(-n_allocs // n_jobs)
        store.upsert_job(job)
        jobs.append(store.job_by_id(job.namespace, job.id))
    allocs = []
    for k in range(n_allocs):
        job, node = jobs[k % n_jobs], nodes[k % n_nodes]
        tg = job.task_groups[0]
        base = AllocMetric(nodes_evaluated=n_nodes, nodes_in_pool=n_nodes)
        metric = base.copy_for_alloc()
        metric.score_node(node.id, "normalized-score", 0.5)
        allocs.append(Allocation(
            id=generate_uuid(), namespace=job.namespace, eval_id="",
            name=f"{job.id}.{tg.name}[{k // n_jobs}]", node_id=node.id,
            node_name=node.name, job_id=job.id, job=job,
            task_group=tg.name, allocated_resources=AllocatedResources(
                tasks={t.name: AllocatedTaskResources(
                    cpu_shares=t.resources.cpu,
                    memory_mb=t.resources.memory_mb) for t in tg.tasks},
                shared=AllocatedSharedResources(
                    disk_mb=tg.ephemeral_disk.size_mb)),
            metrics=metric, client_status="running"))
    store.upsert_allocs(allocs)
    return dump_state(store)


def one_run(codec_file: str, blob_file: str) -> dict:
    """Restore and dump once under ``codec_file``'s codec."""
    from nomad_tpu_torch.structs import codec
    from nomad_tpu_torch.state.restore import dump_state, restore_state
    from nomad_tpu_torch.state.store import StateStore

    source = Path(codec_file).read_text()
    exec(compile(source, codec.__file__, "exec"), codec.__dict__)
    with open(blob_file) as f:
        blob = json.load(f)
    store = StateStore()
    t0 = time.perf_counter()
    restore_state(store, blob)
    t1 = time.perf_counter()
    again = dump_state(store)
    t2 = time.perf_counter()
    if json.loads(json.dumps(again)) != blob:
        raise SystemExit(f"{codec_file}: the dump differs from the blob")
    return {"restore_ms": (t1 - t0) * 1e3, "dump_ms": (t2 - t1) * 1e3}


def spawn(codec_file: str, blob_file: str) -> dict:
    out = subprocess.run(
        [sys.executable, __file__, "--run", codec_file, blob_file],
        capture_output=True, text=True, check=True, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT)))
    return json.loads(out.stdout.strip().splitlines()[-1])


def quartiles(xs):
    q = statistics.quantiles(xs, n=4)
    return {"q1": q[0], "median": statistics.median(xs), "q3": q[2]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nodes", type=int, default=10_000)
    ap.add_argument("--jobs", type=int, default=13)
    ap.add_argument("--allocs", type=int, default=25_100)
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--seed", type=int, default=21)
    ap.add_argument("--run", nargs=2, metavar=("CODEC", "BLOB"),
                    help=argparse.SUPPRESS)
    ap.add_argument("sides", nargs="*", metavar="TAG=CODEC")
    args = ap.parse_args(argv)
    if args.run:
        print(json.dumps(one_run(*args.run)))
        return 0
    if len(args.sides) != 2 or not all("=" in s for s in args.sides):
        ap.error("name two sides, TAG=CODEC TAG=CODEC")
    sides = [tuple(s.split("=", 1)) for s in args.sides]
    sys.path.insert(0, str(ROOT))
    t0 = time.perf_counter()
    blob = build_blob(args.nodes, args.jobs, args.allocs, args.seed)
    with tempfile.TemporaryDirectory() as tmp:
        blob_file = os.path.join(tmp, "blob.json")
        with open(blob_file, "w") as f:
            json.dump(blob, f)
        built_s = time.perf_counter() - t0
        runs = {tag: [] for tag, _ in sides}
        for p in range(args.pairs):
            for tag, codec_file in (sides if p % 2 == 0 else sides[::-1]):
                runs[tag].append(spawn(codec_file, blob_file))
    (a, _), (b, _) = sides
    report = {"nodes": args.nodes, "jobs": args.jobs,
              "allocs": len(blob["allocs"]), "pairs": args.pairs,
              "build_s": built_s, "runs": runs}
    for key in ("restore_ms", "dump_ms"):
        report[key] = {tag: quartiles([r[key] for r in runs[tag]])
                       for tag in runs}
        report[key][f"{b}_wins"] = sum(
            rb[key] < ra[key] for ra, rb in zip(runs[a], runs[b]))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
