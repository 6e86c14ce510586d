#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's wavefront placement path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits nonzero with no result):

  1. card    -- the card's name and power limit (nvidia-smi), CUDA checks;
  2. build   -- nvcc builds every kernel in nomad_tpu_torch/csrc;
  3. kernels -- each kernel x {float32, float64} x B in {32, 128} at the
                headline dispatch shape (E = 32 lanes, P_pad = 2048):
                packed headline lanes plus numpy-seeded fuzz lanes that
                saturate and cross the skip threshold (the compact kernel
                also with spreads and reschedule penalties). Each kernel is
                held against its plain PyTorch version on the same inputs
                on the card: chosen and n_yielded exactly, scores within
                rtol 1e-12 (float64) / 1e-6 (float32; both versions run the
                same IEEE operations in the same order, so they are
                expected to agree to the bit), and timed;
  4. slice   -- the main path: 10,000 nodes (bench.py's world), 32 evals x
                2,000 placements packed with pack_lane_arrays and solved by
                fuse_and_solve in float32 (the run-block kernel), then a
                spread lane and a penalty lane (the compact kernel). Launch
                counts are reset just before and read just after. Checks:
                every placement made, no node over capacity, results equal
                the plain versions on the same fused inputs.

Prints a full JSON report line, the card line, a {"kernels": [...]} line,
and last the contract line {"ok": true, "device": {...}}.
"""
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

N_NODES = 10_000
N_EVALS = 32
N_PLACE = 2_000
P_PAD = 2048                        # _wave_p_bucket(N_PLACE)
ASK = (500.0, 256.0, 150.0)         # mock.job: 500 MHz, 256 MB, 150 MB disk
STATE_INDEX = 10_001
SEED = 20261017
HBM_BYTES_PER_S = 3.35e12           # H100 SXM data sheet
PEAK_FLOPS = {"float32": 67e12,     # H100 SXM, outside the tensor cores
              "float64": 34e12}
RTOL = {"float32": 1e-6, "float64": 1e-12}
KERNEL_REPEATS = 20
DEVICE = "cuda"


def log(*a):
    print(*a, flush=True)


def card_line():
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# the headline world, as arrays

def headline_world(np, tp):
    n = N_NODES
    n_pad = tp.bucket_size(n)
    i = np.arange(n)
    pad = np.zeros(n_pad - n)
    matrix = tp.NodeMatrix(
        n_real=n, n_pad=n_pad, node_ids=[f"bench-node-{k:06d}" for k in i],
        cpu_cap=np.r_[np.array([2000.0, 4000.0, 8000.0])[i % 3], pad],
        mem_cap=np.r_[np.array([4096.0, 8192.0, 16384.0])[i % 3], pad],
        disk_cap=np.r_[np.full(n, 100.0 * 1024), pad],
        dyn_free=np.r_[np.full(n, 12001), np.zeros(n_pad - n)].astype(
            np.int32),
        valid=np.arange(n_pad) < n)
    z = np.zeros(n_pad)
    zi = np.zeros(n_pad, dtype=np.int32)
    usage = tp.UsageState(z, z, z, zi, zi, zi)
    feasible = np.ones(n_pad, dtype=bool)
    return matrix, usage, feasible


def spread_info(np, tp, matrix, count):
    """Two spreads: even over 10 racks, and 50/30/20 targets over 3 zones."""
    n, n_pad = matrix.n_real, matrix.n_pad
    i = np.arange(n)
    vidx = np.full((2, n_pad), -1, dtype=np.int32)
    vidx[0, :n] = i % 10
    vidx[1, :n] = (i // 7) % 3
    desired = np.full((2, 10), -1.0)
    desired[1, :3] = np.array([0.5, 0.3, 0.2]) * count
    return tp.SpreadInfo(
        n_spreads=2, value_index=vidx, n_values=10, desired=desired,
        has_targets=np.array([False, True]),
        weights=np.array([50.0, 50.0]), sum_weights=100.0,
        initial_counts=np.zeros((2, 10), dtype=np.int32))


def pack_lanes(np, tp, svc, world, dtype_name, *, kind, n_lanes):
    matrix, usage, feasible = world
    lanes = []
    rng = np.random.default_rng(SEED)
    for e in range(n_lanes):
        kw = {}
        count = N_PLACE
        if kind == "affinity":
            # a count under 100 keeps the window at 100 slots (B = 128)
            count = 90
            kw["affinity"] = np.r_[rng.choice(
                [0.0, 0.0, 0.5, -0.5, 1.0], matrix.n_real),
                np.zeros(matrix.n_pad - matrix.n_real)]
        elif kind == "spread":
            count = 80
            kw["spread_info"] = spread_info(np, tp, matrix, count)
        elif kind == "penalty":
            count = 60
            kw["penalty_node_ids"] = [
                matrix.node_ids[(37 * k + e) % matrix.n_real]
                if k % 3 == 0 else None for k in range(count)]
        lanes.append(svc.pack_lane_arrays(
            matrix, usage, feasible, ask=ASK, count=count, n_places=count,
            eval_id=f"fused-bench-eval-{kind}-{e:016d}"[-36:],
            state_index=STATE_INDEX, dtype_name=dtype_name, device=DEVICE,
            **kw))
    return lanes


# --------------------------------------------------------------------------
# kernel phase

def fuzz_lane(np, rng, C, B, S, V, dt):
    """A compact table of the reference fuzz's kind (tests/test_wave_block
    _make_case) at a given width: capacities 1..8 force saturation and
    refills, collision counts up to 50 with small job counts push scores
    through the skip threshold both ways."""
    W = 8 + S
    cm = np.zeros((C, W), dtype=dt)
    cm[:, 7] = -1.0
    if S:
        cm[:, 8:] = -1.0
    n_fit = int(rng.integers(B // 2, C + 1))
    ask = float(rng.choice([250.0, 500.0, 1000.0]))
    cpu = rng.choice([2000.0, 4000.0, 8000.0], size=n_fit)
    cm[:n_fit, 0] = np.minimum(rng.integers(1, 9, size=n_fit),
                               np.maximum(cpu // ask, 1.0))
    cm[:n_fit, 1] = rng.integers(0, 3, size=n_fit) * ask
    cm[:n_fit, 2] = rng.integers(0, 3, size=n_fit) * 128.0
    cm[:n_fit, 3] = cpu
    cm[:n_fit, 4] = cpu * 2
    cm[:n_fit, 5] = rng.choice([0.0, 0.0, 0.0, 1.0, 2.0, 50.0], size=n_fit)
    cm[:n_fit, 6] = rng.choice([0.0, 0.0, 0.5, -0.25, 1.0, -1.0],
                               size=n_fit)
    cm[:n_fit, 7] = rng.permutation(C)[:n_fit]
    for s in range(S):
        cm[:n_fit, 8 + s] = rng.integers(-1, V, size=n_fit)
    count = float(rng.choice([1.0, 4.0, 30.0, 2000.0]))
    scal_f = np.array([ask, 128.0, count], dtype=dt)
    n_active = int(rng.integers(1, C - B + 1))
    return cm, scal_f, n_active


def kernel_inputs(np, bp, lanes, *, B, S, penalties, dt, seed):
    """E = 32 lanes at P_pad = 2048: the packed lanes first, numpy-seeded
    fuzz lanes after them; penalties on every third lane when asked."""
    P_pad = P_PAD
    C = P_pad + B
    rng = np.random.default_rng(seed)
    cms, sfs, sis, pens, sps = [], [], [], [], []
    V = 10
    for ln in lanes:
        cm, sf, si, pen, sp = bp.wavefront_compact_host(
            ln.const, ln.init, ln.batch, np.dtype(dt).name, p_pad=P_pad,
            B=B)
        assert cm.shape == (C, 8 + S), cm.shape
        cms.append(cm), sfs.append(sf), sis.append(si), pens.append(pen)
        counts = np.zeros((S, V), dtype=np.int32)
        counts[:, :sp.counts.shape[1]] = sp.counts
        desired = np.full((S, V), -1.0, dtype=dt)
        desired[:, :sp.desired.shape[1]] = sp.desired
        sps.append((counts, desired, sp.has_targets, sp.weights,
                    sp.sum_weights))
    L = int(sis[0][0]) if sis else (14 if B == 32 else 100)
    while len(cms) < N_EVALS:
        cm, sf, n_active = fuzz_lane(np, rng, C, B, S, V, dt)
        pen = np.full(P_pad, -1, dtype=np.int32)
        if penalties and len(cms) % 3 == 0:
            hot = rng.random(P_pad) < 0.3
            pen[hot] = rng.integers(0, C, size=int(hot.sum()))
        cms.append(cm), sfs.append(sf), pens.append(pen)
        sis.append(np.array([L, n_active], dtype=np.int32))
        weights = rng.choice([25.0, 50.0, 100.0], size=S).astype(dt)
        desired = np.where(rng.random((S, V)) < 0.3, -1.0,
                           rng.integers(0, 6, size=(S, V))).astype(dt)
        sps.append((rng.integers(0, 3, size=(S, V)).astype(np.int32),
                    desired, rng.random(S) < 0.5, weights,
                    np.asarray(weights.sum(), dtype=dt)))
    stack = [np.stack(x) for x in zip(*sps)]
    return (np.stack(cms), np.stack(sfs), np.stack(sis), np.stack(pens),
            stack)


def time_once(torch, fn):
    """(result, ms) of one call, timed between CUDA events."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def timed(torch, fn, repeats):
    """Median ms of ``repeats`` warm calls, each between CUDA events."""
    fn()
    torch.cuda.synchronize()
    return statistics.median(time_once(torch, fn)[1]
                             for _ in range(repeats))


def compare(torch, name, got, want, dtype_name):
    """Decisions exactly, scores within the stated rtol; returns the max
    absolute score difference over finite positions."""
    ch, sc, ny = got
    ch_w, sc_w, ny_w = want
    if not torch.equal(ch, ch_w):
        bad = (ch != ch_w).nonzero()[:5].tolist()
        raise AssertionError(f"{name}: chosen differs at {bad}")
    if not torch.equal(ny, ny_w):
        bad = (ny != ny_w).nonzero()[:5].tolist()
        raise AssertionError(f"{name}: n_yielded differs at {bad}")
    fin = torch.isfinite(sc_w)
    if not torch.equal(fin, torch.isfinite(sc)) or not torch.equal(
            sc[~fin], sc_w[~fin]):
        raise AssertionError(f"{name}: non-finite scores differ")
    diff = (sc[fin] - sc_w[fin]).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    tol = RTOL[dtype_name] * sc_w[fin].abs()
    if diff.numel() and bool((diff > tol).any()):
        raise AssertionError(f"{name}: scores beyond rtol "
                             f"{RTOL[dtype_name]} (max abs {err})")
    return err


def bound(name, nbytes, flops, dtype_name):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations"))


# Floating-point operations per slot, counted from the kernel bodies in
# nomad_tpu_torch/csrc: each add, sub, mul, div, min/max, compare and pow
# is one, an fma two (as the peak rate counts it); integer scans and
# conversions are not counted, so the bound stays a lower one.
#   head_terms (wave_common.cuh): fit 1, new cpu/mem 2+2, free cpu/mem
#     3+3, binpack_raw 6 (2 pow, add, sub, 2 clamps), coll 1, anti 5 = 23
#   run-block head (wave_block.cu head_state): + nsc 4, anti+aff 1,
#     final_score 3 (fma, div), low 1 = 32; + 1 compare in each of the
#     two arg-best reductions (winner, runner-up)              -> 34
#   run-block stream value (one per warp lane per run): jq 1, valid 1,
#     jp1 1, free cpu/mem 5+5, binpack_raw 6, coll 1, anti 5, nsc 4,
#     final 4, win_q 3, cross 1                                  -> 37
#   per-placement step (wave_compact.cu): head_terms 23, penalty 1,
#     nscores 6, final (3 adds, fma, div) 6, low 1, arg-best 1  -> 38
#   per spread: the even form's boost (sub, max, div) and its sum 4
#     (the target form takes 7; the lower count keeps a lower bound)
BLOCK_HEAD_OPS, STREAM_OPS, COMPACT_HEAD_OPS, SPREAD_OPS = 34, 37, 38, 4


def kernel_phase(np, torch, bp, wave, kernels, svc, tp, world):
    results = []
    for dtype_name in ("float32", "float64"):
        dt = np.dtype(dtype_name).type
        half, quarter = N_EVALS // 2, N_EVALS // 4
        head = pack_lanes(np, tp, svc, world, dtype_name, kind="plain",
                          n_lanes=half)
        aff = pack_lanes(np, tp, svc, world, dtype_name, kind="affinity",
                         n_lanes=half)
        spread = pack_lanes(np, tp, svc, world, dtype_name, kind="spread",
                            n_lanes=quarter)
        pen = pack_lanes(np, tp, svc, world, dtype_name, kind="penalty",
                         n_lanes=quarter)
        for B in (32, 128):
            for kname in ("wave_block", "wave_compact"):
                if kname == "wave_block":
                    lanes, S, penalties = (head if B == 32 else aff), 0, False
                else:
                    lanes = pen if B == 32 else spread
                    S, penalties = (0 if B == 32 else 2), True
                cm, sf, si, pn, sp = kernel_inputs(
                    np, bp, lanes, B=B, S=S, penalties=penalties, dt=dt,
                    seed=SEED + B + S)
                dev = [torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE)
                       for a in (cm, sf, si, pn)]
                spd = bp.WaveSpread(*(torch.from_numpy(
                    np.ascontiguousarray(a)).to(DEVICE) for a in sp))
                if kname == "wave_block":
                    def run(fn):
                        return fn(dev[0], dev[1], dev[2], spread_alg=False,
                                  B=B)
                    kern, plain = wave.wave_block, wave.wave_block_plain
                else:
                    def run(fn):
                        return fn(dev[0], dev[1], dev[2], dev[3], spd,
                                  spread_alg=False, B=B)
                    kern, plain = wave.wave_compact, wave.wave_compact_plain
                got, _ = time_once(torch, lambda: run(kern))
                want, plain_ms = time_once(torch, lambda: run(plain))
                tag = f"{kname} {dtype_name} B={B} S={S}"
                err = compare(torch, tag, got, want, dtype_name)
                ms = timed(torch, lambda: run(kern), KERNEL_REPEATS)
                # bound: inputs read once, outputs written once; the
                # operations this data needs (steps that place something,
                # or for the run-block kernel at least one run decision
                # per change of chosen node)
                nbytes = (sum(t.nbytes for t in dev[:3])
                          + sum(t.nbytes for t in got))
                if kname == "wave_compact":
                    nbytes += dev[3].nbytes + sum(t.nbytes for t in spd)
                    steps = int((want[0] >= 0).sum())
                    flops = steps * B * (COMPACT_HEAD_OPS + S * SPREAD_OPS)
                else:
                    ch = want[0]
                    runs = int(((ch[:, 1:] != ch[:, :-1]) & (ch[:, 1:] >= 0))
                               .sum() + (ch[:, 0] >= 0).sum())
                    flops = runs * (B * BLOCK_HEAD_OPS + 32 * STREAM_OPS)
                bound_ms, bound_by = bound(kname, nbytes, flops, dtype_name)
                placed = int((want[0] >= 0).sum())
                log(f"kernel {tag}: E={cm.shape[0]} C={cm.shape[1]} "
                    f"placed={placed} match=exact max_abs_err={err:.3e} "
                    f"ms={ms:.4f} plain_ms={plain_ms:.1f} "
                    f"bound_ms={bound_ms:.6f} ({bound_by}, {nbytes} B, "
                    f"{flops} flop)")
                results.append(dict(
                    name=kname, dtype=dtype_name, B=B, S=S,
                    shape=list(cm.shape), placed=placed, max_abs_err=err,
                    ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                    bound_by=bound_by, bytes=nbytes, flops=flops))
    return results


# --------------------------------------------------------------------------
# slice phase: the main path

def check_capacity(np, lane, chosen, count):
    placed = chosen >= 0
    assert int(placed.sum()) == count, (int(placed.sum()), count)
    pos, k = np.unique(chosen[placed], return_counts=True)
    c = lane.const
    for cap, used, ask in ((c.cpu_cap, lane.init.used_cpu, ASK[0]),
                           (c.mem_cap, lane.init.used_mem, ASK[1]),
                           (c.disk_cap, lane.init.used_disk, ASK[2])):
        assert bool(np.all(used[pos] + k * ask <= cap[pos])), "over capacity"
    assert bool(np.all(c.feasible[pos]))


def slice_phase(np, torch, wave, kernels, svc, batch, tp, world):
    t0 = time.perf_counter()
    head = pack_lanes(np, tp, svc, world, "float32", kind="plain",
                      n_lanes=N_EVALS)
    extra = (pack_lanes(np, tp, svc, world, "float32", kind="spread",
                        n_lanes=1)
             + pack_lanes(np, tp, svc, world, "float32", kind="penalty",
                          n_lanes=1))
    pack_ms = (time.perf_counter() - t0) * 1e3
    assert head[0].wavefront_B() == 32 and extra[0].wavefront_B() == 128

    kernels.reset_launches()
    res_head = batch.fuse_and_solve(head, device=DEVICE)
    res_extra = batch.fuse_and_solve(extra, device=DEVICE)
    launches = {k.name: k.launches for k in kernels.KERNELS}
    log(f"slice launches: {launches}")
    assert launches["wave_block"] >= 1, launches
    assert launches["wave_compact"] >= 2, launches

    for lane, (ch, sc, ny) in zip(head + extra, res_head + res_extra):
        check_capacity(np, lane, ch, lane.batch.ask_cpu.shape[0])
        assert ch.dtype == np.int64 and ny.dtype == np.int64
        assert bool(np.all(np.isfinite(sc)))
    total = sum(int((r[0] >= 0).sum()) for r in res_head)
    assert total == N_EVALS * N_PLACE, total

    # the same fused inputs through the plain versions on the card
    for lanes, res in ((head, res_head), (extra, res_extra)):
        for g in batch.fuse_lanes(lanes):
            inp = wave.wave_inputs(g.const, g.init, g.batch,
                                   dtype_name=g.dtype_name)
            cm, sf, si, pn, sp = wave.wave_tensors(inp, torch.device(DEVICE))
            if inp.use_block:
                want = wave.wave_block_plain(cm, sf, si,
                                             spread_alg=g.spread_alg,
                                             B=inp.B)
            else:
                want = wave.wave_compact_plain(cm, sf, si, pn, sp,
                                               spread_alg=g.spread_alg,
                                               B=inp.B)
            for j, li in enumerate(g.idxs):
                P = lanes[li].batch.ask_cpu.shape[0]
                got = tuple(torch.from_numpy(np.asarray(x)).to(DEVICE)
                            for x in res[li])
                compare(torch, f"slice lane {li}", got,
                        tuple(w[j, :P] for w in want), "float32")

    # warm end-to-end time of the headline dispatch (host precompute,
    # transfer, kernel, fetch), host clock; results are on the host
    times = []
    for _ in range(5):
        t1 = time.perf_counter()
        batch.fuse_and_solve(head, device=DEVICE)
        times.append((time.perf_counter() - t1) * 1e3)
    fuse_ms = statistics.median(times)
    # where a warm dispatch's time goes (host clock, medians of 5): the
    # host stacking of lanes, the host compact-table precompute, and the
    # device part (copy in, kernel, copy of the results back to the host)
    parts = {"fuse_lanes": [], "wave_inputs": [], "device": []}
    for _ in range(5):
        t1 = time.perf_counter()
        g = batch.fuse_lanes(head)[0]
        t2 = time.perf_counter()
        inp = wave.wave_inputs(g.const, g.init, g.batch,
                               dtype_name="float32")
        t3 = time.perf_counter()
        out = wave.run_wave(inp, spread_alg=False,
                            device=torch.device(DEVICE))
        [o.cpu() for o in out]
        t4 = time.perf_counter()
        for k, v in zip(parts, (t2 - t1, t3 - t2, t4 - t3)):
            parts[k].append(v * 1e3)
    parts = {k: statistics.median(v) for k, v in parts.items()}
    log(f"slice: {N_EVALS} evals x {N_PLACE} placements x {N_NODES} nodes: "
        f"all {total} placed, no node over capacity, equal to the plain "
        f"versions; pack_ms={pack_ms:.1f} fuse_and_solve_ms={fuse_ms:.2f} "
        f"placements_per_s={total / (fuse_ms / 1e3):.0f}; breakdown ms: "
        + " ".join(f"{k}={v:.2f}" for k, v in parts.items()))
    return dict(launches=launches, fuse_and_solve_ms=fuse_ms,
                fuse_and_solve_ms_all=times, breakdown_ms=parts,
                pack_ms=pack_ms, placements=total,
                placements_per_s=total / (fuse_ms / 1e3),
                B=inp.B, use_block=inp.use_block)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if not (ROOT / "nomad_tpu_torch" / "kernels.py").is_file():
        print("chip_smoke: run from a checkout of the repository "
              "(nomad_tpu_torch/ not found beside this script)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from nomad_tpu_torch import kernels
    from nomad_tpu_torch.solver import batch, service as svc, wave
    from nomad_tpu_torch.solver import binpack as bp
    from nomad_tpu_torch.tensor import pack as tp

    t_start = time.perf_counter()
    card = card_line()
    name = torch.cuda.get_device_name(0)
    log(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}"
        f" | python {sys.version.split()[0]}")
    # matrix products stay full float32 (the port makes none; stated)
    torch.backends.cuda.matmul.allow_tf32 = False

    info = kernels.build()
    log(f"build: {info['seconds']:.1f} s, built {info['built']} "
        f"into {info['dir']}")
    for line in info["log"].splitlines():
        if "registers" in line or line.startswith("=="):
            log("  " + line.strip())

    world = headline_world(np, tp)
    kres = kernel_phase(np, torch, bp, wave, kernels, svc, tp, world)
    sres = slice_phase(np, torch, wave, kernels, svc, batch, tp, world)

    def pick(kname, B):
        return next(r for r in kres if r["name"] == kname
                    and r["dtype"] == "float32" and r["B"] == B)

    line = {"kernels": []}
    for k, B in ((kernels.WAVE_BLOCK, 32), (kernels.WAVE_COMPACT, 128)):
        r = pick(k.name, B)
        line["kernels"].append(dict(
            name=k.name, route="cuda",
            source=f"nomad_tpu_torch/csrc/{k.source}",
            replaces=k.replaces.split()[0], launches=sres["launches"][k.name],
            max_abs_err=max(x["max_abs_err"] for x in kres
                            if x["name"] == k.name),
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=None,
            shape=f"E={r['shape'][0]} C={r['shape'][1]} W={r['shape'][2]} "
                  f"B={B} float32"))
    report = dict(card=card, device=name, kernels=kres, slice=sres,
                  build_s=info["seconds"],
                  total_s=time.perf_counter() - t_start)
    log(f"total {report['total_s']:.1f} s")
    log("report: " + json.dumps(report))
    print(card, flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
