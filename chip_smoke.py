#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's placement paths on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases (any failure raises and the script exits nonzero with no result):

  1. card    -- the card's name and power limit (nvidia-smi), CUDA checks;
  2. build   -- nvcc builds every kernel in nomad_tpu_torch/csrc;
  3. kernels -- every kernel held against its plain PyTorch version on the
                same inputs on the card (chosen, n_yielded and final state
                exactly, scores within rtol 1e-12 (float64) / 1e-6
                (float32; both versions run the same IEEE operations in
                the same order, so they are expected to agree to the
                bit)) and timed, in float32 and float64:
                - wave_block / wave_compact x B in {32, 128} at the
                  headline dispatch shape (E = 32 lanes, P_pad = 2048):
                  packed headline lanes plus numpy-seeded fuzz lanes that
                  saturate and cross the skip threshold (the compact
                  kernel also with spreads and reschedule penalties);
                - dense_scan on one fused group of E = 32 lanes at
                  N = 16,384, P_pad = 2048: 16 packed spread lanes
                  (count 2,000) and 16 fuzz lanes over ports,
                  distinct_hosts, distinct_property, devices, reserved
                  cores, penalties, non-uniform asks and exhaustion;
                  then fuzz groups at N = 256, 1,024 and 4,096 (held
                  against the plain version, untimed);
                - system_fit on the system eval's lane and 8 fuzz lanes;
  4. slice   -- the wave main path: 10,000 nodes (bench.py's world), 32
                evals x 2,000 placements packed with pack_lane_arrays and
                solved by fuse_and_solve in float32 (the run-block
                kernel), then a spread lane and a penalty lane (the
                compact kernel);
  5. dense   -- the dense main path: 32 spread evals x 2,000 placements
                (window 2,000), a distinct_property lane and a
                reserved-core lane, through fuse_and_solve in float32
                (three dense_scan launches);
  6. system  -- one system eval over the 10,000 nodes through
                solve_system_arrays (the system_fit kernel).
  Phases 4-6 reset the launch counts just before and read them just
  after; they check every placement made, no node over capacity (cores
  never below zero, the distinct_property limit held), and results equal
  to the plain versions on the same fused inputs.

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
        elif kind == "dense_spread":
            # count 2,000: the window max(count, 100) outgrows every wave
            # buffer, so these lanes take the dense scan
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


DENSE_FEATURES = ("spreads", "targets", "dp", "devices", "cores", "ports",
                  "distinct", "job_level", "affinity", "penalties",
                  "nonuniform", "low_score", "scarce")


def dense_fuzz_tables(np, rng, *, n, n_pad, p, dtype, limit,
                      features=(), n_active=None):
    """One numpy-seeded dense lane as three dicts of arrays named as the
    NodeConst / NodeState / PlacementBatch fields (the tests build the
    reference's tuples from the same dicts). ``features`` switch on, by
    name: spreads (even form) or targets, dp (distinct_property), devices
    (with affinity weights), cores (reserved cores), ports (static and
    dynamic), distinct (distinct_hosts; job_level for the job-level
    form), affinity, penalties, nonuniform asks (with inactive steps),
    low_score (prior collisions push scores through the skip
    threshold), scarce (small nodes: capacity runs out mid-scan).
    Positions from n to n_pad are padding nodes that never fit."""
    f = set(features)
    bad = f - set(DENSE_FEATURES)
    if bad:
        raise ValueError(f"unknown features {sorted(bad)}")
    dt = np.dtype(dtype).type
    valid = np.arange(n_pad) < n
    caps = [600.0, 1000.0, 1500.0] if "scarce" in f else [2000.0, 4000.0,
                                                          8000.0]
    cpu_cap = np.where(valid, rng.choice(caps, n_pad), 0).astype(dt)
    mem_cap = np.where(valid, rng.choice([4096.0, 8192.0, 16384.0], n_pad),
                       0).astype(dt)
    disk_cap = np.where(valid, 90 * 1024.0, 0).astype(dt)
    k = rng.integers(0, 3, n_pad)
    used_cpu = (k * rng.choice([250.0, 500.0, 1000.0], n_pad)).astype(dt)
    used_mem = (k * rng.choice([256.0, 512.0, 1024.0], n_pad)).astype(dt)
    used_disk = (k * 150.0).astype(dt)
    placed = np.zeros(n_pad, dtype=np.int32)
    if "low_score" in f:
        placed[::3] = rng.integers(1, 4, placed[::3].shape[0])
    placed_job = (placed + rng.integers(0, 2, n_pad)).astype(np.int32)
    aff = np.zeros(n_pad, dtype=dt)
    if "affinity" in f:
        m = rng.random(n_pad) < 0.5
        aff[m] = rng.choice([-1.0, -0.5, 0.25, 0.5, 1.0], int(m.sum()))
    S = 2 if ("spreads" in f or "targets" in f) else 0
    V = 5
    if S:
        vidx = np.where(valid, rng.integers(-1, V, (S, n_pad)),
                        -1).astype(np.int32)
        if "targets" in f:
            desired = np.where(rng.random((S, V)) < 0.3, -1.0,
                               rng.integers(0, p + 1, (S, V))).astype(dt)
            has_t = np.array([True, rng.random() < 0.5])
        else:
            desired = np.full((S, V), -1.0, dtype=dt)
            has_t = np.zeros(S, dtype=bool)
        weights = rng.choice([25.0, 50.0, 100.0], S).astype(dt)
        counts0 = rng.integers(0, 3, (S, V)).astype(np.int32)
    else:
        vidx = np.zeros((0, n_pad), dtype=np.int32)
        desired = np.zeros((0, 1), dtype=dt)
        has_t = np.zeros(0, dtype=bool)
        weights = np.zeros(0, dtype=dt)
        counts0 = np.zeros((0, 1), dtype=np.int32)
    const = dict(
        cpu_cap=cpu_cap, mem_cap=mem_cap, disk_cap=disk_cap,
        feasible=(rng.random(n_pad) > 0.15) & valid, affinity=aff,
        has_affinity=np.asarray("affinity" in f),
        distinct_hosts=np.asarray("distinct" in f),
        distinct_job_level=np.asarray("job_level" in f),
        spread_vidx=vidx, spread_desired=desired, spread_has_targets=has_t,
        spread_weights=weights,
        spread_sum_weights=np.asarray(weights.sum(), dtype=dt),
        n_spreads=np.asarray(S, dtype=np.int32))
    state = dict(
        used_cpu=used_cpu, used_mem=used_mem, used_disk=used_disk,
        placed=placed, placed_job=placed_job,
        static_free=(rng.random(n_pad) > 0.3 if "ports" in f
                     else np.ones(n_pad, dtype=bool)),
        dyn_avail=rng.integers(0, 40, n_pad).astype(np.int32),
        spread_counts=counts0)
    if "dp" in f:
        Dp, Vd = 2, 4
        const["dp_vidx"] = np.where(valid, rng.integers(-1, 3, (Dp, n_pad)),
                                    -1).astype(np.int32)
        const["dp_limit"] = np.array([max(p // 4, 1), max(p // 2, 2)],
                                     dtype=np.int32)
        const["dp_tg_scope"] = np.array([False, True])
        state["dp_counts"] = rng.integers(0, 2, (Dp, Vd)).astype(np.int32)
    if "devices" in f:
        R, Gd = 2, 2
        free = np.where(valid & (rng.random((R, Gd, n_pad)) < 0.6),
                        rng.integers(0, 5, (R, Gd, n_pad)), -1)
        const["dev_aff"] = np.where(
            free >= 0, rng.choice([0.0, 25.0, 50.0, -30.0], (R, Gd, n_pad)),
            0.0).astype(dt)
        const["dev_count"] = np.array([1, 2], dtype=np.int32)
        const["dev_sum_weight"] = np.asarray(80.0, dtype=dt)
        state["dev_free"] = free.astype(np.int32)
    if "cores" in f:
        const["mhz_per_core"] = (cpu_cap / rng.choice([4, 8, 16], n_pad)
                                 ).astype(dt)
        state["cores_free"] = np.where(valid, rng.integers(0, 9, n_pad),
                                       0).astype(np.int32)
    if "nonuniform" in f:
        ask_cpu = rng.choice([250.0, 500.0, 1000.0], p).astype(dt)
        ask_mem = rng.choice([128.0, 256.0, 512.0], p).astype(dt)
    else:
        ask_cpu = np.full(p, 0.0 if "cores" in f else 500.0, dtype=dt)
        ask_mem = np.full(p, 256.0, dtype=dt)
    pen = np.full(p, -1, dtype=np.int32)
    if "penalties" in f:
        hot = rng.random(p) < 0.3
        pen[hot] = rng.integers(0, n, int(hot.sum()))
    active = np.arange(p) < (p if n_active is None else n_active)
    if "nonuniform" in f:
        active &= rng.random(p) > 0.1
    batch = dict(
        ask_cpu=ask_cpu, ask_mem=ask_mem, ask_disk=np.full(p, 300.0, dt),
        n_dyn_ports=np.full(p, 3 if "ports" in f else 0, dtype=np.int32),
        has_static=np.full(p, "ports" in f),
        limit=np.full(p, limit, dtype=np.int32),
        count=np.full(p, int(rng.choice([1, 4, max(p, 1)])), dtype=np.int32),
        penalty_idx=pen, active=active,
        ask_cores=(rng.integers(1, 3, p).astype(np.int32) if "cores" in f
                   else np.zeros(0, dtype=np.int32)))
    return const, state, batch


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


# --------------------------------------------------------------------------
# slice 2: the dense greedy path and system jobs

DP_PLACE, DP_LIMIT = 200, 25        # distinct_property ${meta.rack} lane
CORES_PLACE, CORES_ASK = 200, 2     # reserved-core lane
SYSTEM_ASK = (100.0, 64.0, 10.0)    # the system eval's task group
# the dense kernel phase's common table shapes (every lane of one fused
# group carries the same tables)
DENSE_S, DENSE_V, DENSE_DP, DENSE_VD, DENSE_R, DENSE_GD = 2, 10, 2, 16, 2, 2
# Floating-point operations counted from the kernel bodies
# (csrc/dense_common.cuh, dense_scan.cu, system_fit.cu) as above: each
# add, sub, mul, div, min/max, compare and pow one, an fma two.
#   dense fit check per node and step (score_node before the score):
#     new cpu/mem/disk 3 adds + 3 compares                      -> 6
#   dense score per yielded node and step: free cpu/mem (2 max, 2 div,
#     2 sub, 2 adds) 8, binpack_raw 6, anti 5, nscores 4, other 3,
#     final (fma, div) 3, low 1, arg-best 1                     -> 31
#     plus 4 per spread (SPREAD_OPS)
#   system per node: fit 6, free cpu/mem 8, binpack_raw 6, * 1/18 1 -> 21
# The dense count takes, per step, the fit check and the score of the
# nodes the window yields (n_yielded, this run's data): every step needs
# at least those, while the nodes before the window closes that do not
# yield depend on the data and are left out, so the bound stays a lower
# one.
DENSE_FIT_OPS, DENSE_SCORE_OPS, SYSTEM_OPS = 6, 31, 21


def rack_of(np, n_pad, n):
    """meta.rack = i % 10 (the even spread's attribute), -1 on padding."""
    v = np.full(n_pad, -1, dtype=np.int32)
    v[:n] = np.arange(n) % 10
    return v


def slice2_lanes(np, tp, svc, world, dtype_name, *, n_spread):
    """The dense slice's lanes: ``n_spread`` spread lanes at count 2,000,
    a distinct_property lane (${meta.rack}, limit 25, 200 placements)
    and a reserved-core lane (2 cores, 200 placements; mhz_per_core
    2000/4000/8000 over 4/8/16 cores by i % 3)."""
    matrix, usage, feasible = world
    n, n_pad = matrix.n_real, matrix.n_pad
    lanes = pack_lanes(np, tp, svc, world, dtype_name, kind="dense_spread",
                       n_lanes=n_spread)
    dp = tp.DistinctPropertyInfo(
        value_index=rack_of(np, n_pad, n)[None], limit=np.array([DP_LIMIT]),
        tg_scope=np.array([False]), counts=np.zeros((1, 16), np.int32))
    lanes.append(svc.pack_lane_arrays(
        matrix, usage, feasible, ask=ASK, count=DP_PLACE, n_places=DP_PLACE,
        eval_id="fused-bench-eval-distinct-property", distinct_property=dp,
        state_index=STATE_INDEX, dtype_name=dtype_name, device=DEVICE))
    i = np.arange(n_pad)
    cores = np.where(i < n, np.array([4, 8, 16])[i % 3], 0)
    mhz = np.where(i < n, np.array([2000.0, 4000.0, 8000.0])[i % 3]
                   / np.maximum(cores, 1), 0.0)
    lanes.append(svc.pack_lane_arrays(
        matrix, usage, feasible, ask=(0.0, ASK[1], ASK[2]),
        count=CORES_PLACE, n_places=CORES_PLACE,
        eval_id="fused-bench-eval-reserved-cores", ask_cores=CORES_ASK,
        mhz_per_core=mhz, cores_free=cores.astype(np.int32),
        state_index=STATE_INDEX, dtype_name=dtype_name, device=DEVICE))
    return lanes


def widen(np, const, init, batch, dt):
    """One lane's tables (dicts of arrays) grown to the dense kernel
    phase's common shapes: spread values padded to DENSE_V, and neutral
    distinct_property, device and core tables where the lane has none
    (every node passes them and they add no score term)."""
    n_pad = const["cpu_cap"].shape[0]
    S, V = init["spread_counts"].shape
    assert S == DENSE_S, S
    counts = np.zeros((S, DENSE_V), dtype=np.int32)
    counts[:, :V] = init["spread_counts"]
    desired = np.full((S, DENSE_V), -1.0, dtype=dt)
    desired[:, :V] = const["spread_desired"]
    init["spread_counts"], const["spread_desired"] = counts, desired
    if np.asarray(const.get("dp_vidx", np.zeros((0, 0)))).shape[0] == 0:
        const["dp_vidx"] = np.zeros((DENSE_DP, n_pad), dtype=np.int32)
        const["dp_limit"] = np.full(DENSE_DP, 1 << 30, dtype=np.int32)
        const["dp_tg_scope"] = np.zeros(DENSE_DP, dtype=bool)
        init["dp_counts"] = np.zeros((DENSE_DP, DENSE_VD), dtype=np.int32)
    else:
        dpc = np.zeros((DENSE_DP, DENSE_VD), dtype=np.int32)
        dpc[:, :init["dp_counts"].shape[1]] = init["dp_counts"]
        init["dp_counts"] = dpc
    if np.asarray(const.get("dev_aff", np.zeros((0, 0, 0)))).shape[0] == 0:
        const["dev_aff"] = np.zeros((DENSE_R, DENSE_GD, n_pad), dtype=dt)
        const["dev_count"] = np.ones(DENSE_R, dtype=np.int32)
        const["dev_sum_weight"] = np.asarray(0.0, dtype=dt)
        init["dev_free"] = np.full((DENSE_R, DENSE_GD, n_pad), 1 << 20,
                                   dtype=np.int32)
    P = batch["ask_cpu"].shape[0]
    if np.asarray(const.get("mhz_per_core", np.zeros(0))).shape[0] == 0:
        const["mhz_per_core"] = np.zeros(n_pad, dtype=dt)
        init["cores_free"] = np.full(n_pad, 1 << 20, dtype=np.int32)
        batch["ask_cores"] = np.zeros(P, dtype=np.int32)
    return const, init, batch


def lane_dicts(np, lane, p_pad):
    """A packed lane's tables as dicts, its placement axis padded to
    p_pad with inactive steps."""
    const = {f: np.asarray(getattr(lane.const, f))
             for f in type(lane.const)._fields}
    init = {f: np.asarray(getattr(lane.init, f))
            for f in type(lane.init)._fields}
    batch = {}
    for f in type(lane.batch)._fields:
        a = np.asarray(getattr(lane.batch, f))
        if a.shape[0]:
            fill = {"active": False, "penalty_idx": -1, "count": 1}.get(f, 0)
            out = np.full((p_pad,) + a.shape[1:], fill, dtype=a.dtype)
            out[:a.shape[0]] = a
            a = out
        batch[f] = a
    return const, init, batch


def dense_group(np, bp, dicts):
    """Stack lane dicts into the (E, ...) NodeConst / NodeState /
    PlacementBatch of one fused dispatch."""
    return tuple(
        cls(**{f: np.stack([np.asarray(d[k].get(f, cls._field_defaults.get(
            f))) for d in dicts]) for f in cls._fields})
        for k, cls in enumerate((bp.NodeConst, bp.NodeState,
                                 bp.PlacementBatch)))


def tree_nbytes(trees):
    return sum(t.nbytes for tree in trees for t in tree)


def dense_bound(torch, const, init, batch, out, dtype_name):
    """(bound_ms, bound_by, bytes, flops): the inputs read once, the
    outputs (decisions and final state) written once; the operations
    this run's data needs (see DENSE_FIT_OPS)."""
    nbytes = tree_nbytes((const, init, batch)) + sum(
        t.nbytes for t in out[:3]) + tree_nbytes((out.state,))
    S = const.spread_vidx.shape[1]
    per_node = DENSE_FIT_OPS + DENSE_SCORE_OPS + S * SPREAD_OPS
    flops = int(out.n_yielded.sum()) * per_node
    return bound("dense_scan", nbytes, flops, dtype_name) + (nbytes, flops)


def compare_dense(torch, name, got, want, dtype_name):
    """compare() on the decisions and scores, plus every final state
    field exactly."""
    err = compare(torch, name, got[:3], want[:3], dtype_name)
    for f, g, w in zip(type(got.state)._fields, got.state, want.state):
        if not torch.equal(g, w):
            raise AssertionError(f"{name}: final state {f} differs")
    return err


def dense_kernel_phase(np, torch, bp, dense, svc, tp, world, seed):
    """dense_scan x {float32, float64} on one fused group of E = 32 lanes
    at N = 16,384, P_pad = 2,048: 16 packed spread lanes (count 2,000)
    and 16 numpy-seeded fuzz lanes at fewer active placements, covering
    ports, distinct_hosts (job and group level), distinct_property,
    devices with affinity, reserved cores, penalties, non-uniform asks,
    capacity exhaustion and skip-threshold crossings. Then, untimed, 8
    fuzz lanes at the small node buckets (N = 256 and 1,024, fewer nodes
    than one tile of the kernel's walk) and a mid-size one (N = 4,096)."""
    results = []
    matrix = world[0]
    fuzz_sets = (
        ("targets", "dp", "devices", "cores", "ports", "penalties"),
        ("spreads", "dp", "devices", "cores", "distinct", "low_score"),
        ("targets", "dp", "devices", "cores", "distinct", "job_level",
         "affinity"),
        ("spreads", "dp", "devices", "cores", "nonuniform", "scarce"),
    )
    for dtype_name in ("float32", "float64"):
        dt = np.dtype(dtype_name).type
        rng = np.random.default_rng(seed)
        dicts = [widen(np, *lane_dicts(np, ln, P_PAD), dt) for ln in
                 pack_lanes(np, tp, svc, world, dtype_name,
                            kind="dense_spread", n_lanes=N_EVALS // 2)]
        k = 0
        while len(dicts) < N_EVALS:
            feats = fuzz_sets[k % len(fuzz_sets)]
            c, s, b = dense_fuzz_tables(
                np, rng, n=matrix.n_real, n_pad=matrix.n_pad, p=P_PAD,
                dtype=dtype_name, limit=int(rng.choice([14, 100, 2000])),
                features=feats, n_active=int(rng.integers(200, 1500)))
            dicts.append(widen(np, c, s, b, dt))
            k += 1
        const, init, batch = dense_group(np, bp, dicts)
        c, s, b = dense.lane_tensors(const, init, batch,
                                     dtype_name=dtype_name,
                                     device=torch.device(DEVICE))

        def run(fn):
            return fn(c, s, b, spread_alg=False)

        got, _ = time_once(torch, lambda: run(dense.dense_scan))
        want, plain_ms = time_once(torch, lambda: run(dense.dense_scan_plain))
        tag = f"dense_scan {dtype_name}"
        err = compare_dense(torch, tag, got, want, dtype_name)
        ms = timed(torch, lambda: run(dense.dense_scan), KERNEL_REPEATS)
        bound_ms, bound_by, nbytes, flops = dense_bound(
            torch, c, s, b, want, dtype_name)
        placed = int((want.chosen >= 0).sum())
        log(f"kernel {tag}: E={c.cpu_cap.shape[0]} N={c.cpu_cap.shape[1]} "
            f"P={b.ask_cpu.shape[1]} placed={placed} match=exact "
            f"max_abs_err={err:.3e} ms={ms:.4f} plain_ms={plain_ms:.1f} "
            f"bound_ms={bound_ms:.6f} ({bound_by}, {nbytes} B, {flops} flop)")
        results.append(dict(
            name="dense_scan", dtype=dtype_name,
            shape=[int(x) for x in (*c.cpu_cap.shape, b.ask_cpu.shape[1])],
            placed=placed, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, flops=flops))
        for n, n_pad in ((200, 256), (1000, 1024), (4000, 4096)):
            dicts = [widen(np, *dense_fuzz_tables(
                np, rng, n=n, n_pad=n_pad, p=256, dtype=dtype_name,
                limit=int(rng.choice([3, 14, 100])),
                features=fuzz_sets[k % len(fuzz_sets)]), dt)
                for k in range(8)]
            small = dense.lane_tensors(*dense_group(np, bp, dicts),
                                       dtype_name=dtype_name,
                                       device=torch.device(DEVICE))
            got = dense.dense_scan(*small, spread_alg=False)
            want = dense.dense_scan_plain(*small, spread_alg=False)
            tag = f"dense_scan {dtype_name} N={n_pad}"
            err = compare_dense(torch, tag, got, want, dtype_name)
            log(f"kernel {tag}: E=8 P=256 "
                f"placed={int((want.chosen >= 0).sum())} match=exact "
                f"max_abs_err={err:.3e}")
            results.append(dict(name="dense_scan", dtype=dtype_name,
                                world=f"fuzz N={n_pad}", max_abs_err=err))
    return results


def system_world(np, world, seed):
    """The system eval's inputs over the headline fleet: about 5% of nodes
    infeasible by mask, a static port already taken on about 1%."""
    matrix, usage, feasible = world
    rng = np.random.default_rng(seed)
    n, n_pad = matrix.n_real, matrix.n_pad
    feas = feasible & (rng.random(n_pad) >= 0.05)
    ports_free = rng.random(n_pad) >= 0.01
    return feas, ports_free


def system_kernel_phase(np, torch, bp, dense, system, svc, world, seed):
    """system_fit x {float32, float64} on the system eval's lane (E = 1,
    N = 16,384) and on 8 numpy-seeded fuzz lanes (cores, ports, scarce
    nodes); the system lane is timed."""
    results = []
    matrix, usage, _ = world
    feas, ports_free = system_world(np, world, seed)
    for dtype_name in ("float32", "float64"):
        lane = svc.pack_lane_arrays(
            matrix, usage, feas, ask=SYSTEM_ASK, count=1, n_places=1,
            eval_id="system-bench-eval-0000000000000000",
            state_index=STATE_INDEX, static_ports_free=ports_free,
            n_dyn_ports=1, dtype_name=dtype_name, device=DEVICE)
        rng = np.random.default_rng(seed + 1)
        fuzz = [dense_fuzz_tables(np, rng, n=matrix.n_real,
                                  n_pad=matrix.n_pad, p=1,
                                  dtype=dtype_name, limit=2,
                                  features=("cores", "ports", "scarce"))
                for _ in range(8)]
        groups = (("system", dense_group(np, bp, [lane_dicts(np, lane, 1)])),
                  ("fuzz", dense_group(np, bp, fuzz)))
        for tag, tables in groups:
            c, s, b = dense.lane_tensors(*tables, dtype_name=dtype_name,
                                         device=torch.device(DEVICE))

            def run(fn):
                return fn(c, s, b, spread_alg=False)

            got, _ = time_once(torch, lambda: run(system.system_fit))
            want, plain_ms = time_once(torch,
                                       lambda: run(system.system_fit_plain))
            name = f"system_fit {dtype_name} {tag}"
            if not torch.equal(got[0], want[0]):
                raise AssertionError(f"{name}: fit differs")
            err = float((got[1] - want[1]).abs().max())
            if not bool((got[1] == want[1]).all()):
                tol = RTOL[dtype_name] * want[1].abs()
                if bool(((got[1] - want[1]).abs() > tol).any()):
                    raise AssertionError(f"{name}: scores beyond rtol")
            ms = timed(torch, lambda: run(system.system_fit), KERNEL_REPEATS)
            nbytes = (sum(getattr(t, f).nbytes for t, f in (
                (c, "cpu_cap"), (c, "mem_cap"), (c, "disk_cap"),
                (c, "feasible"), (c, "mhz_per_core"), (s, "used_cpu"),
                (s, "used_mem"), (s, "used_disk"), (s, "static_free"),
                (s, "dyn_avail"), (s, "cores_free")))
                + sum(t[:, :1].nbytes for t in b if t.dim() == 2)
                + got[0].nbytes + got[1].nbytes)
            flops = int(c.cpu_cap.numel()) * SYSTEM_OPS
            bound_ms, bound_by = bound("system_fit", nbytes, flops,
                                       dtype_name)
            n_fit = int(want[0].sum())
            log(f"kernel {name}: E={c.cpu_cap.shape[0]} "
                f"N={c.cpu_cap.shape[1]} fit={n_fit} match=exact "
                f"max_abs_err={err:.3e} ms={ms:.4f} plain_ms={plain_ms:.2f}"
                f" bound_ms={bound_ms:.6f} ({bound_by}, {nbytes} B, "
                f"{flops} flop)")
            results.append(dict(
                name="system_fit", dtype=dtype_name, world=tag,
                shape=[int(x) for x in c.cpu_cap.shape], fit=n_fit,
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                flops=flops))
    return results


def check_dense_lane(np, lane, chosen, n_places):
    """Every placement made, no node over capacity (with the node's
    effective cpu ask under reserved cores), cores never below zero, the
    distinct_property limit held per value."""
    placed = chosen >= 0
    assert int(placed.sum()) == n_places, (int(placed.sum()), n_places)
    pos, k = np.unique(chosen[placed], return_counts=True)
    c, s, b = lane.const, lane.init, lane.batch
    ask_cpu = np.full(pos.shape, float(b.ask_cpu[0]))
    if c.mhz_per_core.shape[0]:
        ask_cpu = ask_cpu + int(b.ask_cores[0]) * c.mhz_per_core[pos]
        assert bool(np.all(s.cores_free[pos] - k * int(b.ask_cores[0])
                           >= 0)), "cores below zero"
    for cap, used, ask in ((c.cpu_cap, s.used_cpu, ask_cpu),
                           (c.mem_cap, s.used_mem, float(b.ask_mem[0])),
                           (c.disk_cap, s.used_disk, float(b.ask_disk[0]))):
        assert bool(np.all(used[pos] + k * ask <= cap[pos])), "over capacity"
    assert bool(np.all(c.feasible[pos]))
    for d in range(c.dp_vidx.shape[0]):
        vals = c.dp_vidx[d][chosen[placed]]
        assert bool((vals >= 0).all())
        per_value = np.bincount(vals) + 0
        assert int(per_value.max()) <= int(c.dp_limit[d]), per_value


def dense_slice_phase(np, torch, dense, kernels, svc, batch, tp, world):
    """The main path of slice 2: 32 spread lanes (count 2,000) plus the
    distinct_property and reserved-core lanes through fuse_and_solve in
    float32; three fused groups, each a dense_scan launch."""
    t0 = time.perf_counter()
    lanes = slice2_lanes(np, tp, svc, world, "float32", n_spread=N_EVALS)
    pack_ms = (time.perf_counter() - t0) * 1e3
    assert not any(ln.wavefront_ok() for ln in lanes)

    kernels.reset_launches()
    res = batch.fuse_and_solve(lanes, device=DEVICE)
    launches = {k.name: k.launches for k in kernels.KERNELS}
    log(f"dense slice launches: {launches}")
    assert launches["dense_scan"] >= 3, launches

    for lane, (ch, sc, ny) in zip(lanes, res):
        check_dense_lane(np, lane, ch, lane.batch.ask_cpu.shape[0])
        assert bool(np.all(np.isfinite(sc)))
    spread_total = sum(int((r[0] >= 0).sum()) for r in res[:N_EVALS])
    assert spread_total == N_EVALS * N_PLACE, spread_total

    # the same fused inputs through the plain version on the card; the
    # kernel's own numbers at the main path's shape come from the largest
    # group (the 32 spread lanes)
    kernel = None
    for g in batch.fuse_lanes(lanes):
        c, s, b = dense.lane_tensors(g.const, g.init, g.batch,
                                     dtype_name=g.dtype_name,
                                     device=torch.device(DEVICE))

        def run(fn):
            return fn(c, s, b, spread_alg=g.spread_alg)

        want, plain_ms = time_once(torch, lambda: run(dense.dense_scan_plain))
        for j, li in enumerate(g.idxs):
            P = lanes[li].batch.ask_cpu.shape[0]
            got = tuple(torch.from_numpy(np.asarray(x)).to(DEVICE)
                        for x in res[li])
            compare(torch, f"dense slice lane {li}", got,
                    tuple(w[j, :P] for w in want[:3]), "float32")
        if len(g.idxs) == N_EVALS:
            ms = timed(torch, lambda: run(dense.dense_scan), KERNEL_REPEATS)
            bound_ms, bound_by, nbytes, flops = dense_bound(
                torch, c, s, b, want, "float32")
            kernel = dict(
                shape=[int(x) for x in (*c.cpu_cap.shape,
                                        b.ask_cpu.shape[1])],
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, bytes=nbytes, flops=flops)
            log(f"kernel dense_scan float32 main path: E={c.cpu_cap.shape[0]}"
                f" N={c.cpu_cap.shape[1]} P={b.ask_cpu.shape[1]} "
                f"ms={ms:.4f} plain_ms={plain_ms:.1f} "
                f"bound_ms={bound_ms:.6f} ({bound_by}, {nbytes} B, "
                f"{flops} flop)")

    # warm end-to-end time of the dense dispatch, host clock
    times = []
    for _ in range(5):
        t1 = time.perf_counter()
        batch.fuse_and_solve(lanes, device=DEVICE)
        times.append((time.perf_counter() - t1) * 1e3)
    fuse_ms = statistics.median(times)
    # where it goes (medians of 5, host clock with a synchronize after
    # each device part): stacking the lanes, shipping the tables, the
    # kernels, fetching the results
    parts = {"fuse_lanes": [], "to_device": [], "kernels": [], "fetch": []}
    dev = torch.device(DEVICE)
    for _ in range(5):
        t1 = time.perf_counter()
        groups = batch.fuse_lanes(lanes)
        t2 = time.perf_counter()
        tens = [dense.lane_tensors(g.const, g.init, g.batch,
                                   dtype_name=g.dtype_name, device=dev)
                for g in groups]
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        outs = [dense.dense_scan(*t, spread_alg=False) for t in tens]
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        [[x.cpu().numpy() for x in o[:3]] for o in outs]
        t5 = time.perf_counter()
        for k, v in zip(parts, (t2 - t1, t3 - t2, t4 - t3, t5 - t4)):
            parts[k].append(v * 1e3)
    parts = {k: statistics.median(v) for k, v in parts.items()}
    total = sum(int((r[0] >= 0).sum()) for r in res)
    log(f"dense slice: {N_EVALS} spread evals x {N_PLACE} + distinct "
        f"property {DP_PLACE} + cores {CORES_PLACE} placements x {N_NODES}"
        f" nodes: all {total} placed, capacity / cores / distinct_property "
        f"held, equal to the plain version; pack_ms={pack_ms:.1f} "
        f"fuse_and_solve_ms={fuse_ms:.2f} "
        f"placements_per_s={total / (fuse_ms / 1e3):.0f}; breakdown ms: "
        + " ".join(f"{k}={v:.2f}" for k, v in parts.items()))
    return dict(launches=launches, fuse_and_solve_ms=fuse_ms,
                fuse_and_solve_ms_all=times, breakdown_ms=parts,
                pack_ms=pack_ms, placements=total,
                placements_per_s=total / (fuse_ms / 1e3),
                groups=len(batch.fuse_lanes(lanes)), kernel=kernel)


def system_phase(np, torch, system, kernels, svc, world, seed):
    """One system eval over all 10,000 nodes through solve_system_arrays
    in float32 (the system_fit kernel)."""
    matrix, usage, _ = world
    feas, ports_free = system_world(np, world, seed)
    kw = dict(ask=SYSTEM_ASK, eval_id="system-bench-eval-0000000000000000",
              state_index=STATE_INDEX, static_ports_free=ports_free,
              n_dyn_ports=1, dtype_name="float32", device=DEVICE)
    kernels.reset_launches()
    lane, chosen, scores = svc.solve_system_arrays(matrix, usage, feas, **kw)
    launches = {k.name: k.launches for k in kernels.KERNELS}
    log(f"system launches: {launches}")
    assert launches["system_fit"] >= 1, launches
    n = matrix.n_real
    expect = (feas[:n] & ports_free[:n]
              & (SYSTEM_ASK[0] <= matrix.cpu_cap[:n])
              & (SYSTEM_ASK[1] <= matrix.mem_cap[:n])
              & (SYSTEM_ASK[2] <= matrix.disk_cap[:n]))
    assert bool(np.array_equal(chosen >= 0, expect)), (
        "system fit differs from the expected mask")
    assert bool(np.all(np.isfinite(scores))) and bool(
        np.all((scores >= 0) & (scores <= 1)))
    idx, _ = svc.placements(lane, chosen)
    assert bool(np.array_equal(idx[expect], np.arange(n)[expect]))
    times = []
    for _ in range(5):
        t1 = time.perf_counter()
        svc.solve_system_arrays(matrix, usage, feas, **kw)
        times.append((time.perf_counter() - t1) * 1e3)
    ms = statistics.median(times)
    log(f"system eval: {n} nodes, {int(expect.sum())} fit (expected mask "
        f"held), solve_system_arrays_ms={ms:.2f} (median of 5, host clock)")
    return dict(launches=launches, solve_system_arrays_ms=ms,
                solve_system_arrays_ms_all=times, fit=int(expect.sum()))


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=SEED,
                    help="seed of the numpy fuzz lanes (default %(default)s)")
    args = ap.parse_args(argv)
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
    from nomad_tpu_torch.solver import batch, dense, service as svc, system
    from nomad_tpu_torch.solver import binpack as bp, wave
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
    kres += dense_kernel_phase(np, torch, bp, dense, svc, tp, world,
                               args.seed)
    kres += system_kernel_phase(np, torch, bp, dense, system, svc, world,
                                args.seed)
    sres = slice_phase(np, torch, wave, kernels, svc, batch, tp, world)
    dres = dense_slice_phase(np, torch, dense, kernels, svc, batch, tp,
                             world)
    yres = system_phase(np, torch, system, kernels, svc, world, args.seed)

    def pick(kname, **kw):
        return next(r for r in kres if r["name"] == kname
                    and r["dtype"] == "float32"
                    and all(r.get(k) == v for k, v in kw.items()))

    # each kernel's row: its float32 time at the main path's shape (the
    # dense kernel on the main path's own spread group), and its launches
    # in the main-path run of its own path
    rows = ((kernels.WAVE_BLOCK, pick("wave_block", B=32), sres),
            (kernels.WAVE_COMPACT, pick("wave_compact", B=128), sres),
            (kernels.DENSE_SCAN, dres["kernel"], dres),
            (kernels.SYSTEM_FIT, pick("system_fit", world="system"), yres))
    line = {"kernels": []}
    for k, r, path in rows:
        line["kernels"].append(dict(
            name=k.name, route="cuda",
            source=f"nomad_tpu_torch/csrc/{k.source}",
            replaces=k.replaces.split()[0],
            launches=path["launches"][k.name],
            max_abs_err=max(x["max_abs_err"] for x in kres
                            if x["name"] == k.name),
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=None,
            shape=" ".join(str(x) for x in r["shape"]) + " float32"))
    report = dict(card=card, device=name, seed=args.seed, kernels=kres,
                  slice=sres, dense_slice=dres, system=yres,
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
