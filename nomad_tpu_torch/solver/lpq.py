"""The whole-queue LP tier, ``tpu-lpq`` (port of nomad_tpu/solver/lpq.py).

One barrier generation's lanes are solved together: the LP-eligible lanes
that share one node universe (the same NodeMatrix) are relaxed into ONE
lane x node program, solved on the device by the LP relaxation kernel
(csrc/lp_relax.cu), then rounded to integral placements and repaired
against a shared free-capacity ledger on the host; every other lane goes
through the greedy fused dispatch (``batch.fuse_and_solve``) and the
cross-lane fixpoint against the same ledger.

The relaxation (``lp_relax``): ``steps`` iterations of

    price = ask . mu^T                       (3-term fma chain)
    X     = softmax over each lane's feasible nodes of (V - price) / temp
    load  = sum over lanes, in lane order, of (X * pcount)^T . ask
    mu    = max(0, mu + 0.5 * (load - free) / max(free, 1))

with temp annealed geometrically from 0.25 to 0.02 (``lp_temperatures``),
then a final X at temp 0.02. Float32 on every device, as in the
reference. ``lp_relax_plain`` fixes the order of every operation, and the
kernel follows it, so the two agree to the bit on the card:

  * the row sum of the softmax is XLA's CPU tree: sequential sums over
    windows of 32 consecutive nodes, repeated while more than 32 partial
    sums remain, then one sequential sum (``_tree_sum``);
  * both contractions are sequential fused multiply-add chains, as XLA's
    CPU dot emits them: the price over r = 0, 1, 2 and the load over the
    lanes in order;
  * the final pass multiplies by 1/0.02 (XLA turns the division by the
    constant into that multiply), the annealing steps divide by their
    temperature;
  * on the CPU, ``exp`` is XLA's own float32 expansion and every result
    below the smallest normal float32 is flushed to zero, as XLA's CPU
    runtime does; on the card neither (torch.exp, no flushing), as in the
    kernel.

A lane with preemption tables that does not fit its rounded node
evicts in the repair pass through the host Preemptor
(scheduler/preemption.py) over the Allocation structs the lane was
packed from (``_try_preempt``); its result carries the eviction rows.
``LpqBarrier`` runs each generation under the
dispatch guard's watchdog deadline (solver/guard.py), and
``make_lpq_hook`` is the ``tpu-lpq`` scheduler's solve hook; tracer
spans, ``metrics`` counters and the shadow audit come with telemetry.

Knobs (read at each use):
  NOMAD_TPU_TORCH_LPQ            0 turns the tier off: tpu-lpq evals take
                                 the greedy tier (lpq_active)
  NOMAD_TPU_TORCH_LPQ_BATCH      evals the server's LP worker drains into
                                 one generation (128, >= 1)
  NOMAD_TPU_TORCH_LPQ_GATHER_MS  how long that drain keeps gathering
                                 arrivals (20 ms)
  NOMAD_TPU_TORCH_LPQ_STEPS      annealing/dual-ascent iterations (48, >= 4)
  NOMAD_TPU_TORCH_LPQ_COMPARE    0 skips the greedy-replay quality comparison
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import kernels
from ..device import DeviceLike
from ..structs.config import SCHED_ALG_TPU_LPQ
from .binpack import BINPACK_MAX
from .guard import run_dispatch
from .scoring import _EXP32, _libm
from .service import PackedLane

# Safety valve: a straggler eval thread must not wedge every blocked
# participant.
LPQ_BARRIER_TIMEOUT_S = 10.0

# Pad the lane axis to these buckets so one kernel shape serves many
# batch sizes.
_L_BUCKETS = (8, 16, 32, 64, 128, 256)

# Negative-value weight for preemption: a preemption lane's nodes that
# fit only after evictions enter V at this weight times the normalized
# eviction need (_lane_values).
_PREEMPT_VALUE_PENALTY = 0.5

T_HI, T_LO, ETA = 0.25, 0.02, 0.5
# the final pass's 1 / T_LO, as XLA folds the division by the constant
T_FINAL_INV = np.float32(1.0) / np.float32(T_LO)
# the kernel's per-row scratch holds N / 32 window sums in shared memory
N_MAX = 1 << 18
_F32_TINY = float(np.finfo(np.float32).tiny)


def lpq_enabled() -> bool:
    """NOMAD_TPU_TORCH_LPQ=0 is the kill switch: the greedy tier runs
    even when the scheduler algorithm selects tpu-lpq (reference
    lpq.py:93)."""
    return os.environ.get("NOMAD_TPU_TORCH_LPQ", "1") != "0"


def lpq_batch_width() -> int:
    try:
        return max(1, int(os.environ.get("NOMAD_TPU_TORCH_LPQ_BATCH",
                                         "128")))
    except ValueError:
        return 128


def lpq_gather_s() -> float:
    try:
        return max(0.0, float(os.environ.get(
            "NOMAD_TPU_TORCH_LPQ_GATHER_MS", "20")) / 1e3)
    except ValueError:
        return 0.02


def lpq_active(state) -> bool:
    """Is the LP tier selected (the scheduler configuration's algorithm
    is tpu-lpq) and not switched off? (reference lpq.py:122)"""
    if not lpq_enabled():
        return False
    cfg = getattr(state, "scheduler_config", None)
    cfg = cfg() if cfg is not None else None
    return cfg is not None and cfg.scheduler_algorithm == SCHED_ALG_TPU_LPQ


def lpq_steps() -> int:
    try:
        return max(4, int(os.environ.get("NOMAD_TPU_TORCH_LPQ_STEPS", "48")))
    except ValueError:
        return 48


def lpq_compare_enabled() -> bool:
    return os.environ.get("NOMAD_TPU_TORCH_LPQ_COMPARE", "1") != "0"


# ---------------------------------------------------------------------------
# stats (status surfaces; metrics counters come with the telemetry slice)

_STATS_LOCK = threading.Lock()
_STATS = {
    "solves": 0, "lanes_total": 0, "placements": 0, "repairs": 0,
    "failed": 0, "preempt_evictions": 0, "greedy_lanes": 0,
    "quality_delta": None, "frag_delta": None,
}


def _stat(name: str, n=1) -> None:
    with _STATS_LOCK:
        _STATS[name] += n


def _stat_set(name: str, v) -> None:
    with _STATS_LOCK:
        _STATS[name] = v


def lpq_stats() -> dict:
    """Snapshot of the tier's counters, with evals per solve and the
    repair rate."""
    with _STATS_LOCK:
        out = dict(_STATS)
    solves = out["solves"]
    out["evals_per_solve"] = (out["lanes_total"] / solves) if solves else 0.0
    out["repair_rate"] = (out["repairs"] / out["placements"]
                          if out["placements"] else 0.0)
    return out


def _reset_for_tests() -> None:
    with _STATS_LOCK:
        for k in _STATS:
            _STATS[k] = None if k in ("quality_delta", "frag_delta") else 0


# ---------------------------------------------------------------------------
# eligibility

def lp_lane_eligible(lane: PackedLane) -> bool:
    """Does the joint LP model everything this lane asks for: pure
    cpu/mem/disk binpack plus job anti-affinity, preemption lanes too
    (their repair evicts through the host Preemptor). Ports, devices,
    cores, spreads, affinities, distinct_* and reschedule penalties solve
    on the greedy fused path within the same generation."""
    c, b = lane.const, lane.batch
    return (c.spread_vidx.shape[0] == 0
            and c.dp_vidx.shape[0] == 0
            and c.dev_aff.shape[0] == 0
            and c.mhz_per_core.shape[0] == 0
            and not bool(c.has_affinity)
            and not bool(c.distinct_hosts)
            and b.ask_cores.shape[0] == 0
            and int(np.asarray(b.n_dyn_ports)[0]) == 0
            and not bool(np.asarray(b.has_static)[0])
            and bool((np.asarray(b.penalty_idx) < 0).all())
            and bool(np.asarray(b.active).all()))


def _l_bucket(n: int) -> int:
    for b in _L_BUCKETS:
        if n <= b:
            return b
    return int(2 ** np.ceil(np.log2(n)))


# ---------------------------------------------------------------------------
# the relaxation: temperatures, plain version, wrapper

def lp_temperatures(steps: int) -> np.ndarray:
    """The (steps,) float32 annealing temperatures, as the traced program
    computes them: frac = f32(t) * (1 / f32(max(steps - 1, 1))) (XLA
    folds the division into that multiply), temp = 0.25 * powf(0.08,
    frac), powf being libm's, which XLA's CPU lowering matches."""
    f32 = np.float32
    recip = f32(1.0) / f32(max(steps - 1, 1))
    frac = np.arange(steps).astype(f32) * recip
    powf = _libm().powf
    base = f32(T_LO / T_HI)
    return np.array([f32(T_HI) * f32(powf(base, float(x))) for x in frac],
                    dtype=f32)


def _ftz(x: torch.Tensor) -> torch.Tensor:
    """Flush float32 results below the smallest normal to zero on the CPU
    (XLA's CPU runtime runs with flush-to-zero); identity on the card,
    where neither the kernel nor PyTorch flushes."""
    if x.device.type != "cpu":
        return x
    return torch.where(x.abs() < _F32_TINY, torch.zeros_like(x), x)


def _fma32(a, b, c) -> torch.Tensor:
    """float32 a * b + c with one rounding, elementwise on any device:
    the product is exact in float64, the sum is rounded to odd in float64
    (TwoSum error, then one step toward it when the sum is even), and
    the conversion to float32 then rounds correctly."""
    a, b, c = torch.broadcast_tensors(a, b, c)
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    v = s - p
    err = (p - (s - v)) + (cd - v)
    even = (s.view(torch.int64) & 1) == 0
    fix = (err != 0) & even & torch.isfinite(s)
    inf = torch.full_like(s, float("inf"))
    s = torch.where(fix, torch.nextafter(s, torch.where(err > 0, inf, -inf)),
                    s)
    return _ftz(s.float())


def _exp32(x: torch.Tensor) -> torch.Tensor:
    """float32 exp: torch.exp on the card (expf, as the kernel calls it);
    on the CPU XLA's own expansion (scoring._xla_exp, vectorized) with the
    result flushed to zero below the smallest normal."""
    if x.device.type != "cpu":
        return torch.exp(x)
    c = _EXP32
    f32 = torch.float32

    def k(v):
        return torch.tensor(float(v), dtype=f32)

    xc = torch.minimum(torch.maximum(x, k(c["lo"])), k(c["hi"]))
    n = torch.floor(_fma32(xc, k(c["log2e"]), k(0.5))).clamp(-127.0, 127.0)
    r = _fma32(-n, k(c["c2"]), _fma32(-n, k(c["c1"]), xc))
    y = torch.full_like(r, float(c["poly"][0]))
    for coef in c["poly"][1:]:
        y = _fma32(y, r, k(coef))
    y = _ftz(_fma32(y, _ftz(r * r), r) + 1.0)
    # 2**n from its exponent bits (n = -127 gives 0, as a flushed 2**-127)
    two_n = ((n.to(torch.int32) + 127) << 23).view(f32)
    return _ftz(y * two_n)


def _tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Row sums of (L, N) in XLA's CPU order: windows of 32 consecutive
    values summed in order from 0, repeated while more than 32 partial
    sums remain, then the rest summed in order from 0."""
    while x.shape[1] > 32:
        w = x.reshape(x.shape[0], -1, 32)
        acc = torch.zeros_like(w[:, :, 0])
        for k in range(32):
            acc = _ftz(acc + w[:, :, k])
        x = acc
    acc = torch.zeros_like(x[:, 0])
    for k in range(x.shape[1]):
        acc = _ftz(acc + x[:, k])
    return acc


def _logits(V, feas, any_f, ask, mu, temp=None):
    """The logits (V - price) / temp over each lane's feasible nodes (-inf
    elsewhere; 0 on a lane with none); ``temp`` None is the final pass
    (times 1/0.02)."""
    price = _fma32(ask[:, 2:3], mu[None, :, 2],
                   _fma32(ask[:, 1:2], mu[None, :, 1],
                          _ftz(ask[:, 0:1] * mu[None, :, 0])))
    d = _ftz(V - price)
    logit = _ftz(d * float(T_FINAL_INV) if temp is None else d / temp)
    logit = torch.where(feas, logit, torch.full_like(logit, float("-inf")))
    return torch.where(any_f, logit, torch.zeros_like(logit))


def _row_stats(logit):
    """Each row's max (L, 1) and the sum of exp(logit - max) (L,)."""
    mx = logit.amax(dim=1, keepdim=True)
    return mx, _tree_sum(_exp32(_ftz(logit - mx)))


def _x_from(logit, mx, ssum, live):
    """The masked softmax from the rows' statistics."""
    X = _ftz(_exp32(_ftz(logit - mx)) / ssum[:, None])
    return torch.where(live, X, torch.zeros_like(X))


def _x_at(V, feas, any_f, live, ask, mu, *, temp=None):
    """X at one temperature: the masked softmax of (V - price) / temp
    over each lane's feasible nodes (a row with none is uniform before
    ``live`` zeroes it); ``temp`` None is the final pass (times 1/0.02)."""
    logit = _logits(V, feas, any_f, ask, mu, temp)
    mx, ssum = _row_stats(logit)
    return _x_from(logit, mx, ssum, live)


def _mu_step(X, pcount, ask, free, cap, mu):
    """One dual-price step: the load as an fma chain over the lanes in
    order, then mu = max(0, mu + 0.5 * (load - free) / cap)."""
    zero = torch.zeros_like(mu)
    Xp = _ftz(X * pcount[:, None])
    load = zero
    for lane in range(Xp.shape[0]):
        load = _fma32(Xp[lane][:, None], ask[lane][None, :], load)
    step = _ftz(_ftz(_ftz(load - free) * ETA) / cap)
    m = _ftz(mu + step)
    return torch.where(m > 0, m, zero)


def lp_relax_plain(V, feas, ask, pcount, free, active, temps
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch LP relaxation: V (L, N) float32, feas (L, N) bool,
    ask (L, 3), pcount (L,), free (N, 3), active (L,) bool, temps (steps,)
    float32 -> X (L, N), mu (N, 3), on the inputs' device."""
    cap = free.clamp_min(1.0)
    any_f = feas.any(dim=1, keepdim=True)
    live = any_f & active[:, None]
    mu = torch.zeros_like(free)
    for t in range(temps.shape[0]):
        X = _x_at(V, feas, any_f, live, ask, mu, temp=temps[t])
        mu = _mu_step(X, pcount, ask, free, cap, mu)
    return _x_at(V, feas, any_f, live, ask, mu), mu


def _lp_check(V, feas, ask, pcount, free, active, temps) -> Tuple[int, int]:
    """Check the relaxation's inputs; returns (L, N). L is a lane bucket
    (_l_bucket's), N a power of two from 64 to N_MAX, every tensor
    float32 (bool masks) and on one device."""
    if not isinstance(V, torch.Tensor) or V.dim() != 2:
        raise ValueError("V must be an (L, N) torch.Tensor")
    if not isinstance(temps, torch.Tensor) or temps.dim() != 1 \
            or temps.shape[0] < 1:
        raise ValueError("temps must be a non-empty (steps,) torch.Tensor")
    dev = V.device
    L, N = V.shape
    if _l_bucket(L) != L:
        raise ValueError(f"L = {L} is not a lane bucket {_L_BUCKETS}")
    if N < 64 or N > N_MAX or N & (N - 1):
        raise ValueError(f"N = {N}: expected a power of two in "
                         f"[64, {N_MAX}]")
    want = (("V", V, torch.float32, (L, N)),
            ("feas", feas, torch.bool, (L, N)),
            ("ask", ask, torch.float32, (L, 3)),
            ("pcount", pcount, torch.float32, (L,)),
            ("free", free, torch.float32, (N, 3)),
            ("active", active, torch.bool, (L,)),
            ("temps", temps, torch.float32, (temps.shape[0],)))
    for name, t, dt, shape in want:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != dt:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {dt} "
                            "(the LP is float32 on every device)")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
    return L, N


def lp_relax(V, feas, ask, pcount, free, active, temps
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The LP relaxation on the inputs' device: the plain version for CPU
    tensors, the lp_relax kernel (one launch: 2 * steps + 3 passes on the
    current stream) for CUDA tensors. Returns (X (L, N), mu (N, 3)) float32."""
    L, N = _lp_check(V, feas, ask, pcount, free, active, temps)
    dev = V.device
    if dev.type == "cpu":
        return lp_relax_plain(V, feas, ask, pcount, free, active, temps)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    X = torch.empty((L, N), dtype=torch.float32, device=dev)
    mu = torch.empty((N, 3), dtype=torch.float32, device=dev)
    any_f = torch.empty(L, dtype=torch.int32, device=dev)
    rmax = torch.empty(L, dtype=torch.float32, device=dev)
    rsum = torch.empty(L, dtype=torch.float32, device=dev)
    ins = [t.contiguous() for t in (V, feas, ask, pcount, free, active,
                                    temps)]
    kernels.LP_RELAX.launch(torch.float32,
                            ins + [X, mu, any_f, rmax, rsum],
                            [L, N, temps.shape[0]])
    return X, mu


# ---------------------------------------------------------------------------
# The lane-sharded relaxation (parallel/mesh.py mesh_lpq): one cell holds
# V and feas whole (gathered once), its lanes [l0, l1), and its own copy
# of mu and of every lane's row statistics. Four phases, each one launch
# of the lp_shard entry point on the card (the plain version here for CPU
# tensors): init (any-feasible flags, mu = 0), rows (the cell's lanes'
# (max, sum) at step t, t < 0 the final pass), nodes (step t's X from the
# gathered statistics for every lane, the load over the lanes in order,
# the mu update), write_x (the final X of the cell's lanes, from the
# statistics of the final pass: rows at t = -1).

LP_INIT, LP_ROWS, LP_NODES, LP_WRITE_X = 0, 1, 2, 3


class LpShardCell:
    """One cell of the lane-sharded relaxation."""

    __slots__ = ("V", "feas", "ask", "pcount", "free", "active", "temps",
                 "l0", "l1", "X", "mu", "any_f", "rmax", "rsum")

    def __init__(self, V, feas, ask, pcount, free, active, temps, *,
                 l0: int, l1: int):
        L, N = _lp_check(V, feas, ask, pcount, free, active, temps)
        if not 0 <= l0 < l1 <= L:
            raise ValueError(f"lanes [{l0}, {l1}) outside [0, {L})")
        self.V, self.feas, self.ask, self.pcount = V, feas, ask, pcount
        self.free, self.active, self.temps = free, active, temps
        self.l0, self.l1 = l0, l1
        dev = V.device
        self.X = torch.empty((l1 - l0, N), dtype=torch.float32, device=dev)
        self.mu = torch.zeros((N, 3), dtype=torch.float32, device=dev)
        self.any_f = torch.zeros(L, dtype=torch.int32, device=dev)
        self.rmax = torch.zeros(L, dtype=torch.float32, device=dev)
        self.rsum = torch.zeros(L, dtype=torch.float32, device=dev)


def _lp_shard_plain(c: LpShardCell, phase: int, t: int) -> None:
    if phase == LP_INIT:
        c.any_f.copy_(c.feas.any(dim=1).to(torch.int32))
        c.mu.zero_()
        return
    any_f = c.any_f.bool()[:, None]
    live = any_f & c.active[:, None]
    temp = None if t < 0 else c.temps[t]
    if phase == LP_NODES:
        logit = _logits(c.V, c.feas, any_f, c.ask, c.mu, temp)
        X = _x_from(logit, c.rmax[:, None], c.rsum, live)
        c.mu.copy_(_mu_step(X, c.pcount, c.ask, c.free,
                            c.free.clamp_min(1.0), c.mu))
        return
    rs = slice(c.l0, c.l1)
    if phase == LP_WRITE_X:
        temp = None
    logit = _logits(c.V[rs], c.feas[rs], any_f[rs], c.ask[rs], c.mu, temp)
    if phase == LP_ROWS:
        mx, ssum = _row_stats(logit)
        c.rmax[rs] = mx[:, 0]
        c.rsum[rs] = ssum
    else:
        c.X.copy_(_x_from(logit, c.rmax[rs, None], c.rsum[rs], live[rs]))


def lp_shard_phase(c: LpShardCell, phase: int, t: int) -> None:
    """Run one phase of the lane-sharded relaxation on cell ``c``: the
    plain version for CPU tensors, one lp_shard launch for CUDA
    tensors."""
    dev = c.V.device
    if dev.type == "cpu":
        _lp_shard_plain(c, phase, t)
        return
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    L, N = c.V.shape
    ins = [x.contiguous() for x in (c.V, c.feas, c.ask, c.pcount, c.free,
                                    c.active, c.temps)]
    kernels.LP_SHARD.launch(
        torch.float32, ins + [c.X, c.mu, c.any_f, c.rmax, c.rsum],
        [L, N, c.temps.shape[0], phase, t, c.l0, c.l1])


# ---------------------------------------------------------------------------
# host-side assembly, rounding, repair

class _LaneView:
    """One LP-eligible lane mapped back to canonical (NodeMatrix) node
    order, with everything rounding, repair and scoring need."""

    __slots__ = ("lane", "inv", "feas", "feas_fit", "used", "placed",
                 "placed0", "ask", "count", "P", "relief", "relief_ok",
                 "V", "n_yield")

    def __init__(self, lane: PackedLane):
        self.lane = lane
        c, s, b = lane.const, lane.init, lane.batch
        n_pad = np.asarray(c.cpu_cap).shape[0]
        n = len(lane.order)
        perm = np.concatenate([np.asarray(lane.order, dtype=np.int64),
                               np.arange(n, n_pad, dtype=np.int64)])
        inv = np.empty(n_pad, dtype=np.int64)
        inv[perm] = np.arange(n_pad)
        self.inv = inv                      # canonical j -> shuffled pos

        def canon(arr, dtype=np.float64):
            return np.asarray(arr)[inv].astype(dtype)

        self.feas = np.asarray(c.feasible)[inv]
        self.used = np.stack([canon(s.used_cpu), canon(s.used_mem),
                              canon(s.used_disk)])          # (3, N)
        self.placed = canon(s.placed, np.int64)
        # pre-repair snapshot: the score replay carries from the initial
        # counts; the repair pass mutates self.placed as it commits
        self.placed0 = self.placed.copy()
        self.ask = np.asarray([float(np.asarray(b.ask_cpu)[0]),
                               float(np.asarray(b.ask_mem)[0]),
                               float(np.asarray(b.ask_disk)[0])])
        self.count = max(float(np.asarray(b.count)[0]), 1.0)
        self.P = int(np.asarray(b.ask_cpu).shape[0])
        # a preemption lane: what evicting every eligible candidate (a
        # valid row at least 10 priority levels below the job) would
        # free per node, (3, N)
        self.relief = None
        self.relief_ok = None
        if lane.ptab is not None:
            pt = lane.ptab
            elig = (np.asarray(pt.valid)
                    & (int(np.asarray(pt.job_prio))
                       - np.asarray(pt.prio) >= 10))
            self.relief = np.stack([
                (np.asarray(pt.cpu) * elig).sum(axis=1)[inv],
                (np.asarray(pt.mem) * elig).sum(axis=1)[inv],
                (np.asarray(pt.disk) * elig).sum(axis=1)[inv],
            ]).astype(np.float64)


def _lane_values(view: _LaneView, cap: np.ndarray, spread_alg: bool
                 ) -> None:
    """Fill view.V / view.feas_fit: the host oracle's initial score per
    node (binpack BestFit-v3 + job anti-affinity), -1e9 where the ask
    does not fit; a preemption lane's nodes that fit only after
    evictions are feasible at a negative value term, the normalized
    eviction need."""
    ask = view.ask
    new = view.used + ask[:, None]                          # (3, N)
    free_frac_cpu = 1.0 - new[0] / np.maximum(cap[0], 1e-9)
    free_frac_mem = 1.0 - new[1] / np.maximum(cap[1], 1e-9)
    total = np.power(10.0, free_frac_cpu) + np.power(10.0, free_frac_mem)
    raw = (total - 2.0) if spread_alg else (20.0 - total)
    binpack = np.clip(raw, 0.0, BINPACK_MAX) / BINPACK_MAX
    coll = view.placed > 0
    anti = np.where(coll, -(view.placed + 1.0) / view.count, 0.0)
    V = (binpack + anti) / (1.0 + coll.astype(np.float64))
    fit_alone = view.feas & (new <= cap).all(axis=0)
    if view.relief is None:
        view.feas_fit = fit_alone
    else:
        with_relief = view.feas & (new <= cap + view.relief).all(axis=0)
        view.relief_ok = with_relief & ~fit_alone
        view.feas_fit = fit_alone | with_relief
        need = np.clip(new - cap, 0.0, None) / np.maximum(
            ask[:, None], 1e-9)
        V = V - _PREEMPT_VALUE_PENALTY * np.where(
            view.relief_ok, need.sum(axis=0), 0.0)
    view.V = np.where(view.feas_fit, V, -1e9)
    view.n_yield = int(view.feas_fit.sum())


def _score_follow(view: _LaneView, chosen_canon: np.ndarray,
                  cap: np.ndarray, spread_alg: bool) -> np.ndarray:
    """Host scores for the solved sequence: the oracle formula with the
    lane-local sequential carry."""
    used = view.used.copy()
    placed = view.placed0.astype(np.float64).copy()
    ask = view.ask
    out = np.zeros(len(chosen_canon), dtype=np.float64)
    for p, b in enumerate(chosen_canon):
        if b < 0:
            continue
        new_cpu = used[0, b] + ask[0]
        new_mem = used[1, b] + ask[1]
        fc = 1.0 - new_cpu / max(cap[0, b], 1e-9)
        fm = 1.0 - new_mem / max(cap[1, b], 1e-9)
        total = np.power(10.0, fc) + np.power(10.0, fm)
        raw = (total - 2.0) if spread_alg else (20.0 - total)
        binpack = min(max(raw, 0.0), BINPACK_MAX) / BINPACK_MAX
        if placed[b] > 0:
            out[p] = (binpack - (placed[b] + 1.0) / view.count) / 2.0
        else:
            out[p] = binpack
        used[:, b] += ask
        placed[b] += 1
    return out


def _frag_and_pack(cap_cpu, cap_mem, used_cpu, used_mem
                   ) -> Tuple[float, float]:
    """The quality scoreboard's formulas: capacity-weighted fragmentation
    index and packing efficiency over occupied nodes, for a hypothetical
    usage vector."""
    with np.errstate(divide="ignore", invalid="ignore"):
        util_cpu = np.clip(np.where(cap_cpu > 0,
                                    used_cpu / np.maximum(cap_cpu, 1e-9),
                                    0.0), 0.0, 1.0)
        util_mem = np.clip(np.where(cap_mem > 0,
                                    used_mem / np.maximum(cap_mem, 1e-9),
                                    0.0), 0.0, 1.0)
    free_cpu, free_mem = 1.0 - util_cpu, 1.0 - util_mem
    usable = np.minimum(free_cpu, free_mem)
    free_any = np.maximum(free_cpu, free_mem)
    w = (np.where(cap_cpu.sum() > 0,
                  cap_cpu / max(cap_cpu.sum(), 1e-9), 0.0)
         + np.where(cap_mem.sum() > 0,
                    cap_mem / max(cap_mem.sum(), 1e-9), 0.0)) / 2.0
    denom = float((free_any * w).sum())
    frag = 1.0 - float((usable * w).sum()) / denom if denom > 1e-12 \
        else 0.0
    occ = (used_cpu > 0) | (used_mem > 0)
    if occ.any():
        pack = (float(used_cpu[occ].sum()
                      / max(cap_cpu[occ].sum(), 1e-9))
                + float(used_mem[occ].sum()
                        / max(cap_mem[occ].sum(), 1e-9))) / 2.0
    else:
        pack = 0.0
    return frag, pack


def _try_preempt(view: _LaneView, b: int, free: np.ndarray,
                 evicted_ids: set, evicted_so_far: List) -> Optional[List]:
    """The host Preemptor (scheduler/preemption.py) on canonical node b
    over the lane's candidates not yet evicted in this generation: the
    eviction set, when the ask fits the shared ledger afterwards, else
    None."""
    from ..scheduler.preemption import Preemptor
    from ..structs import (
        AllocatedResources, AllocatedSharedResources, AllocatedTaskResources)

    lane = view.lane
    if lane.cand_allocs is None:
        return None
    pos = int(view.inv[b])
    A = np.asarray(lane.ptab.valid).shape[1]
    cands = [a for a in lane.cand_allocs[pos][:A]
             if a.id not in evicted_ids]
    if not cands:
        return None
    svc = lane.service
    tg = lane.tg
    ask_res = AllocatedResources(
        tasks={t.name: AllocatedTaskResources(
            cpu_shares=t.resources.cpu, memory_mb=t.resources.memory_mb)
            for t in tg.tasks},
        shared=AllocatedSharedResources(disk_mb=tg.ephemeral_disk.size_mb))
    preemptor = Preemptor(svc.job.priority, svc.ctx,
                          (svc.job.namespace, svc.job.id))
    preemptor.set_node(lane.nodes[b])
    preemptor.set_preemptions(evicted_so_far)
    preemptor.set_candidates(cands)
    evicted = preemptor.preempt_for_task_group(ask_res)
    if not evicted:
        return None
    freed = np.zeros(3)
    for a in evicted:
        cr = a.allocated_resources.comparable()
        freed += (cr.cpu_shares, cr.memory_mb, cr.disk_mb)
    # verify against the shared ledger: other lanes may have landed on b
    # in this generation
    if not (view.ask <= free[:, b] + freed + 1e-9).all():
        return None
    return evicted


def solve_queue(lanes: List[PackedLane], ledger: Dict[str, list],
                device=None) -> List[tuple]:
    """Solve one barrier generation on ``device`` (one device or a list of
    cells; default every CUDA card, no card raises): the
    largest group of LP-eligible lanes sharing one NodeMatrix through the
    joint relaxation, everything else through the greedy fused dispatch
    and the cross-lane fixpoint, both against ``ledger`` (node id ->
    [free cpu, mem, disk, dynamic ports]). Returns per-lane (chosen,
    scores, n_yielded) in input order, in each lane's shuffled
    coordinates."""
    from .batch import _cross_lane_fixpoint, fuse_and_solve, resolve_cells

    cells = resolve_cells(device)
    dev = cells[0]
    results: List = [None] * len(lanes)
    # group LP-eligible lanes by node universe (matrix identity); the
    # largest group solves jointly, the rest ride the greedy path
    groups: Dict[int, List[int]] = {}
    for i, lane in enumerate(lanes):
        if lane.matrix is not None and lp_lane_eligible(lane):
            groups.setdefault(id(lane.matrix), []).append(i)
    lp_idx: List[int] = max(groups.values(), key=len) if groups else []

    if lp_idx:
        lp_results = _solve_lp_group([lanes[i] for i in lp_idx], ledger,
                                     device=cells)
        _stat("solves")
        _stat("lanes_total", len(lp_idx))
        for i, res in zip(lp_idx, lp_results):
            results[i] = res

    greedy_idx = [i for i in range(len(lanes)) if results[i] is None]
    if greedy_idx:
        sub = [lanes[i] for i in greedy_idx]
        sub_res = fuse_and_solve(sub, device=cells)
        # charge greedy placements against the ledger the LP committed
        # into, resolving residual conflicts of wave lanes
        _cross_lane_fixpoint(sub, sub_res, ledger, device=dev)
        _stat("greedy_lanes", len(sub))
        for i, res in zip(greedy_idx, sub_res):
            results[i] = res
    return results


def _lp_inputs(views: List[_LaneView], free: np.ndarray):
    """The relaxation's numpy inputs, lanes padded to their bucket:
    V, feas, ask, pcount, free (N, 3) and active."""
    L = len(views)
    L_pad = _l_bucket(L)
    n_pad = free.shape[1]
    V = np.full((L_pad, n_pad), -1e9, dtype=np.float32)
    feas = np.zeros((L_pad, n_pad), dtype=bool)
    ask = np.zeros((L_pad, 3), dtype=np.float32)
    pcount = np.zeros(L_pad, dtype=np.float32)
    active = np.zeros(L_pad, dtype=bool)
    for li, v in enumerate(views):
        V[li] = v.V
        feas[li] = v.feas_fit
        ask[li] = v.ask
        pcount[li] = v.P
        active[li] = True
    return (V, feas, ask, pcount,
            np.ascontiguousarray(free.T.astype(np.float32)), active)


def _solve_lp_group(lanes: List[PackedLane], ledger: Dict[str, list],
                    device=None,
                    timings: Optional[Dict[str, float]] = None
                    ) -> List[tuple]:
    """Solve one group of LP-eligible lanes over one NodeMatrix: assemble
    values and free capacity (the ledger overrides it), relax on
    ``device``, round by largest remainder, repair every placement
    against the shared ledger, publish the committed capacity into the
    ledger. ``timings``, when given, receives host-clock ms per phase.
    ``device`` may be a list of cells: the relaxation then runs over the
    grid parallel.mesh.pick_mesh chooses for (L_pad, N) (lanes on evals),
    or on the first cell when there is none."""
    from .batch import resolve_cells
    cells = resolve_cells(device)
    dev = cells[0]
    clock = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        if timings is not None:
            timings[name] = timings.get(name, 0.0) + (now - clock[0]) * 1e3
        clock[0] = now

    matrix = lanes[0].matrix
    spread_alg = bool(lanes[0].spread_alg)
    views = [_LaneView(lane) for lane in lanes]
    cap = np.stack([np.asarray(matrix.cpu_cap, dtype=np.float64),
                    np.asarray(matrix.mem_cap, dtype=np.float64),
                    np.asarray(matrix.disk_cap, dtype=np.float64)])
    for v in views:
        _lane_values(v, cap, spread_alg)

    # shared free capacity: conservative elementwise max of lane usage
    # (lanes differ only by their own plan deltas), overridden by the
    # cross-generation ledger where earlier commits already charged it
    used_max = np.maximum.reduce([v.used for v in views])
    free = np.clip(cap - used_max, 0.0, None)               # (3, N)
    pos_of = matrix.__dict__.get("_pos_index")
    if pos_of is None:
        pos_of = {nid: i for i, nid in enumerate(matrix.node_ids)}
        matrix._pos_index = pos_of
    for nid, f in ledger.items():
        b = pos_of.get(nid)
        if b is not None:
            free[0, b] = min(free[0, b], f[0])
            free[1, b] = min(free[1, b], f[1])
            free[2, b] = min(free[2, b], f[2])
    lap("views")

    # -- device solve ---------------------------------------------------
    L = len(views)
    arrays = _lp_inputs(views, free)
    temps = lp_temperatures(lpq_steps())
    grid = None
    if len(cells) > 1:
        from ..parallel import mesh
        grid = mesh.pick_mesh(arrays[0].shape[0], arrays[0].shape[1], cells)
    if grid is not None:
        s_in, _ = mesh.shard_lpq_inputs(grid, *arrays)
        X_dev, mu_dev = mesh.mesh_lpq(grid, s_in, temps)
    else:
        X_dev, mu_dev = lp_relax(*(torch.from_numpy(a).to(dev)
                                   for a in arrays + (temps,)))
    X = X_dev[:L].cpu().numpy().astype(np.float64)
    mu = mu_dev.cpu().numpy().astype(np.float64)            # (N, 3)
    lap("lp")

    # -- round: per-lane integral counts by largest remainder -----------
    assigned: List[np.ndarray] = []
    for li, v in enumerate(views):
        x = np.where(v.feas_fit, X[li], 0.0)
        tot = x.sum()
        if tot <= 0:
            assigned.append(np.full(v.P, -1, dtype=np.int64))
            continue
        x = x / tot
        counts = np.floor(x * v.P).astype(np.int64)
        deficit = v.P - int(counts.sum())
        if deficit > 0:
            frac = x * v.P - counts
            frac[~v.feas_fit] = -1.0
            for b in np.argsort(-frac)[:deficit]:
                counts[b] += 1
        # expand to one node index per placement, best-X nodes first
        order = np.argsort(-x)
        chosen = np.repeat(order, counts[order])[:v.P]
        if chosen.shape[0] < v.P:
            chosen = np.concatenate([
                chosen, np.full(v.P - chosen.shape[0], -1, np.int64)])
        assigned.append(chosen)

    # -- repair: charge every placement against the shared ledger -------
    # a preemption lane's placement that does not fit evicts through the
    # host Preemptor (a lane packed from structs carries its candidates)
    free_r = free.copy()
    evicted_ids: set = set()
    evicted_so_far: List = []
    chosen_out = [np.full(v.P, -1, dtype=np.int64) for v in views]
    evict_out = [
        (np.zeros((v.P, np.asarray(v.lane.ptab.valid).shape[1]),
                  dtype=bool) if v.lane.ptab is not None else None)
        for v in views]
    n_repair = n_fail = n_evict = 0

    def commit(v, li, p, b, evicted=None):
        nonlocal n_evict
        free_r[:, b] -= v.ask
        if evicted:
            freed = np.zeros(3)
            cands = v.lane.cand_allocs[int(v.inv[b])]
            for a in evicted:
                cr = a.allocated_resources.comparable()
                freed += (cr.cpu_shares, cr.memory_mb, cr.disk_mb)
                evicted_ids.add(a.id)
                evicted_so_far.append(a)
                for a_i, cand in enumerate(cands):
                    if cand.id == a.id:
                        evict_out[li][p, a_i] = True
                        break
            free_r[:, b] += freed
            n_evict += len(evicted)
        v.placed[b] += 1
        chosen_out[li][p] = b

    for li, v in enumerate(views):
        for p in range(v.P):
            b = int(assigned[li][p])
            if b >= 0 and (v.ask <= free_r[:, b] + 1e-9).all():
                commit(v, li, p, b)
                continue
            if b >= 0 and v.relief_ok is not None and v.relief_ok[b]:
                evicted = _try_preempt(v, b, free_r, evicted_ids,
                                       evicted_so_far)
                if evicted:
                    commit(v, li, p, b, evicted)
                    continue
            # rounded node infeasible at commit time: place by the
            # greedy rule -- best host score minus LP congestion price,
            # over verified remaining capacity
            n_repair += 1
            fits = v.feas_fit & (free_r + 1e-9 >= v.ask[:, None]).all(
                axis=0)
            if fits.any():
                price = mu @ v.ask                          # (N,)
                score = np.where(fits, v.V - price, -np.inf)
                commit(v, li, p, int(np.argmax(score)))
                continue
            if v.relief_ok is not None:
                relievable = np.flatnonzero(v.relief_ok)
                placed_ok = False
                for b2 in relievable[np.argsort(-v.V[relievable])][:8]:
                    evicted = _try_preempt(v, int(b2), free_r,
                                           evicted_ids, evicted_so_far)
                    if evicted:
                        commit(v, li, p, int(b2), evicted)
                        placed_ok = True
                        break
                if placed_ok:
                    continue
            n_fail += 1     # nothing fits anywhere: blocked

    # publish the committed capacity into the cross-generation ledger
    touched = np.flatnonzero((free_r != free).any(axis=0))
    for b in touched:
        nid = matrix.node_ids[b] if b < len(matrix.node_ids) else None
        if nid is None:
            continue
        f = ledger.get(nid)
        if f is None:
            ledger[nid] = [free_r[0, b], free_r[1, b], free_r[2, b], 0]
        else:
            f[0], f[1], f[2] = free_r[0, b], free_r[1, b], free_r[2, b]

    n_placed = sum(int((c >= 0).sum()) for c in chosen_out)
    _stat("placements", n_placed)
    _stat("repairs", n_repair)
    _stat("failed", n_fail)
    _stat("preempt_evictions", n_evict)
    lap("round_repair")

    # -- batch-level quality: LP vs a greedy replay of the same queue ---
    if lpq_compare_enabled():
        try:
            _compare_quality(views, cap, free, chosen_out, spread_alg)
        except Exception:  # noqa: BLE001 -- comparison is advisory
            pass
    lap("compare")

    # -- per-lane outputs in shuffled coordinates -----------------------
    out: List[tuple] = []
    for li, v in enumerate(views):
        scores = _score_follow(v, chosen_out[li], cap, spread_alg)
        chosen_shuf = np.where(chosen_out[li] >= 0,
                               v.inv[np.clip(chosen_out[li], 0, None)],
                               -1).astype(np.int64)
        n_yielded = np.full(v.P, max(v.n_yield, 1), dtype=np.int64)
        if evict_out[li] is not None:
            out.append((chosen_shuf, scores, n_yielded, evict_out[li]))
        else:
            out.append((chosen_shuf, scores, n_yielded))
    lap("follow")
    return out


def _compare_quality(views, cap, free0, chosen_out, spread_alg: bool
                     ) -> None:
    """Fragmentation and packing efficiency of the LP solution against a
    greedy replay of the same queue from the same starting state (the
    greedy tier's rule: per-placement max host score over fitting nodes,
    sequential carry)."""
    used0 = cap - free0
    # LP usage
    used_lp = used0.copy()
    for li, v in enumerate(views):
        for b in chosen_out[li]:
            if b >= 0:
                used_lp[:, int(b)] += v.ask
    # greedy replay usage
    used_g = used0.copy()
    for v in views:
        placed = v.placed0.astype(np.float64).copy()
        for _ in range(v.P):
            new = used_g + v.ask[:, None]
            fits = v.feas & (new <= cap).all(axis=0)
            if not fits.any():
                continue
            fc = 1.0 - new[0] / np.maximum(cap[0], 1e-9)
            fm = 1.0 - new[1] / np.maximum(cap[1], 1e-9)
            total = np.power(10.0, fc) + np.power(10.0, fm)
            raw = (total - 2.0) if spread_alg else (20.0 - total)
            binpack = np.clip(raw, 0.0, BINPACK_MAX) / BINPACK_MAX
            coll = placed > 0
            anti = np.where(coll, -(placed + 1.0) / v.count, 0.0)
            score = np.where(fits, (binpack + anti) / (1.0 + coll),
                             -np.inf)
            b = int(np.argmax(score))
            used_g[:, b] += v.ask
            placed[b] += 1

    valid = cap[0] > 0
    frag_lp, pack_lp = _frag_and_pack(
        cap[0][valid], cap[1][valid], used_lp[0][valid], used_lp[1][valid])
    frag_g, pack_g = _frag_and_pack(
        cap[0][valid], cap[1][valid], used_g[0][valid], used_g[1][valid])
    _stat_set("quality_delta", round(pack_lp - pack_g, 6))
    _stat_set("frag_delta", round(frag_lp - frag_g, 6))


# ---------------------------------------------------------------------------
# the rendezvous barrier

class LpqBarrier:
    """Rendezvous point for one LPQ batch of eval threads: solve() blocks,
    done() is called when a thread has no more solves, and the last
    arriver dispatches the whole generation through solve_queue.
    Multi-task-group evals rendezvous once per task group (generations),
    sharing one free-capacity ledger so later generations see earlier
    commitments. Each generation's solve_queue runs under the dispatch
    guard's watchdog (``run_dispatch(label="solver.lpq")``): a timeout or
    an error reaches every waiter of its generation as DispatchFailed.
    ``device`` (one device or a list of cells, default every CUDA card)
    is resolved here, and a CUDA cell's kernel library is built or
    loaded here, outside every deadline."""

    def __init__(self, participants: int, plan_group_hint=None,
                 device: DeviceLike = None):
        from .batch import dispatch_cell, resolve_cells

        self._cells = resolve_cells(device)
        self._enter = dispatch_cell(self._cells)
        if any(c.type == "cuda" for c in self._cells):
            kernels.load()
        self._cv = threading.Condition()
        self._participants = participants
        self._finished = 0
        self._waiting: List[Tuple[PackedLane, dict]] = []
        self._generation = 0
        self._plan_group_hint = plan_group_hint
        self._ledger: Dict[str, list] = {}

    @property
    def cells(self):
        """The devices every dispatch of this barrier runs on."""
        return self._cells

    def done(self) -> None:
        with self._cv:
            self._finished += 1
            if self._ready_locked():
                self._dispatch_locked()

    def solve(self, lane: PackedLane):
        cell: dict = {}
        with self._cv:
            self._waiting.append((lane, cell))
            if self._ready_locked():
                self._dispatch_locked()
            while "result" not in cell and "error" not in cell:
                gen = self._generation
                if not self._cv.wait(timeout=LPQ_BARRIER_TIMEOUT_S):
                    # straggler safety valve: if our lane is still
                    # queued, dispatch what we have
                    if (self._generation == gen
                            and any(c is cell for _, c in self._waiting)):
                        self._dispatch_locked()
            if "error" in cell:
                raise cell["error"]
            return cell["result"]

    def _ready_locked(self) -> bool:
        return bool(self._waiting
                    and len(self._waiting) + self._finished
                    >= self._participants)

    def _dispatch_locked(self) -> None:
        batch = self._waiting
        self._waiting = []
        self._generation += 1
        lanes = [lane for lane, _ in batch]
        try:
            results = run_dispatch(
                lambda: solve_queue(lanes, self._ledger, device=self._cells),
                label="solver.lpq", device=self._enter)
            for (_, cell), res in zip(batch, results):
                cell["result"] = res
        except Exception as e:  # noqa: BLE001 -- waiters must not strand
            for _, cell in batch:
                cell["error"] = e
        finally:
            hint = self._plan_group_hint
            if hint is not None and batch:
                try:
                    hint(len(batch))
                except Exception:  # noqa: BLE001 -- advisory only
                    pass
            self._cv.notify_all()


def make_lpq_hook(barrier: LpqBarrier):
    """The solve hook the LP tier's GenericSchedulers call instead of
    service.solve (reference lpq.py:882): pack on the calling thread,
    solve the whole queue at the barrier, materialize on the calling
    thread. Returns the TpuPlacements, or None when the task group is not
    eligible or, on CPU cells, the generation's dispatch failed (counted
    as a host fallback; the caller's host stack then places the task
    group). On a card the DispatchFailed reaches the caller."""
    from .guard import DispatchFailed, host_fallback_allowed, \
        note_host_fallback

    def hook(service, tg, places, nodes, penalties):
        lane = service.pack(tg, places, nodes, penalties)
        if lane is None:
            return None
        try:
            res = barrier.solve(lane)
        except DispatchFailed:
            if not host_fallback_allowed(barrier.cells):
                raise
            note_host_fallback()
            return None
        return service.materialize(lane, *res)
    return hook
