"""Score and selection helpers shared by the wave, dense, system and
preemption paths (the plain PyTorch halves of
nomad_tpu/solver/binpack.py's _binpack_score, _spread_score,
_select_window, _distance and the preemption score).

Every expression evaluates the same IEEE operations in the same order as
XLA's lowering of the reference, so the plain versions agree with the JAX
programs to the bit on the CPU and with the CUDA kernels on the card:

  * ``clip(raw) / 18 + rest`` is one fused multiply-add by the rounded
    reciprocal of 18 (``_score``);
  * ``ask_cpu + ask_cores * mhz_per_core`` is one fused multiply-add
    (``_fma``);
  * ``10 ** x`` is libm ``pow``/``powf`` on the CPU (``_pow10``);
  * the preemption distance's ``dc*dc + dm*dm + dd*dd`` is
    ``fma(dd, dd, fma(dc, dc, dm*dm))``, and its square root is correctly
    rounded (``_distance``, ``_sqrt``);
  * ``exp`` is XLA's own CPU expansion (a rational approximation in
    float64, a polynomial in float32, every multiply-add fused), not
    libm's (``_exp``).

On the CPU the fused and libm operations go through the C library, once
per distinct input; on the card through ``torch.addcmul``, ``torch.pow``
and ``torch.exp``, which the CUDA math library evaluates as the kernels
do.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import functools
import math
import struct

import numpy as np
import torch

from .binpack import (
    BINPACK_MAX, MAX_SKIP, PREEMPT_SCORE_ORIGIN, PREEMPT_SCORE_RATE,
    SKIP_THRESHOLD)

_BIG = 2 ** 31 - 1          # int32 max: the reference's "no order" value


@functools.lru_cache(maxsize=1)
def _libm():
    lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    for name, t in (("pow", ctypes.c_double), ("powf", ctypes.c_float)):
        getattr(lib, name).argtypes = [t, t]
        getattr(lib, name).restype = t
    for name, t in (("fma", ctypes.c_double), ("fmaf", ctypes.c_float)):
        getattr(lib, name).argtypes = [t, t, t]
        getattr(lib, name).restype = t
    return lib


@functools.lru_cache(maxsize=1 << 18)
def _libm_pow10(x: float, f64: bool) -> float:
    lib = _libm()
    return (lib.pow if f64 else lib.powf)(10.0, x)


@functools.lru_cache(maxsize=1 << 18)
def _libm_fma(a: float, b: float, c: float, f64: bool) -> float:
    lib = _libm()
    return (lib.fma if f64 else lib.fmaf)(a, b, c)


def _host_map(fn, x: torch.Tensor, y: torch.Tensor = None):
    """Apply a scalar libm function elementwise to one or two CPU tensors,
    once per distinct input (slot values repeat from step to step)."""
    a = x.numpy()
    f64 = a.dtype == np.float64
    if y is None:
        key = a.ravel()
    else:
        # pairs as one complex value each, so a 1-D unique finds them
        b = y.numpy().ravel()
        key = a.ravel().astype(np.complex128) + 1j * b.astype(np.complex128)
    uniq, inv = np.unique(key, return_inverse=True)
    if y is None:
        vals = [fn(float(v), f64) for v in uniq.tolist()]
    else:
        vals = [fn(v.real, v.imag, f64) for v in uniq.tolist()]
    out = np.asarray(vals, dtype=a.dtype)
    return torch.from_numpy(out[inv.ravel()].reshape(a.shape))


def _pow10(x: torch.Tensor) -> torch.Tensor:
    """10 ** x, elementwise. On the card this is torch.pow, which calls the
    CUDA math library's pow/powf as the kernels do. On the CPU torch.pow
    (SLEEF) rounds differently from libm in about 1.6% of inputs, while
    the reference's XLA CPU lowering calls libm pow/powf; one ulp can flip
    a near-tie between two nodes, so the CPU path calls libm."""
    if x.device.type != "cpu":
        return torch.pow(10.0, x)
    return _host_map(_libm_pow10, x)


def _binpack_raw(free_cpu, free_mem, spread_alg: bool):
    """BestFit v3 / worst-fit fitness clipped to [0, BINPACK_MAX]
    (reference: structs/funcs.go:236,263); _score normalizes it."""
    total = _pow10(free_cpu) + _pow10(free_mem)
    raw = total - 2.0 if spread_alg else 20.0 - total
    return raw.clamp(0.0, BINPACK_MAX)


def _fma(a, b, c):
    """a * b + c with one rounding, broadcast: libm fma on the CPU,
    torch.addcmul on the card (the reference's reserved-core cpu ask
    ``ask_cpu + ask_cores * mhz_per_core``, which XLA contracts)."""
    a, b, c = torch.broadcast_tensors(a, b, c)
    if a.device.type != "cpu":
        return torch.addcmul(c, a, b)
    # one libm call per distinct (a, b, c) triple
    an, bn, cn = (t.contiguous().numpy().ravel() for t in (a, b, c))
    f64 = an.dtype == np.float64
    trip = np.stack([an, bn, cn], axis=1)
    uniq, inv = np.unique(trip, axis=0, return_inverse=True)
    vals = [_libm_fma(float(x), float(y), float(z), f64)
            for x, y, z in uniq.tolist()]
    out = np.asarray(vals, dtype=an.dtype)[np.asarray(inv).ravel()]
    return torch.from_numpy(out.reshape(a.shape))


def _binpack_plus(bp_raw, rest):
    """bp_raw / BINPACK_MAX + rest as XLA lowers it (rank.go:571
    fitness/18): the division by the constant becomes a multiply by its
    reciprocal rounded in the working dtype, and that multiply and the
    add are one fused multiply-add (libm fma on the CPU, torch.addcmul on
    the card, fma() in the kernels)."""
    recip = torch.full((), 1.0, dtype=bp_raw.dtype,
                       device=bp_raw.device) / BINPACK_MAX
    if bp_raw.device.type == "cpu":
        r = float(recip)
        return _host_map(lambda x, y, f64: _libm_fma(x, r, y, f64),
                         bp_raw.contiguous(),
                         rest.expand_as(bp_raw).contiguous())
    return torch.addcmul(rest, bp_raw, recip)


def _score(bp_raw, rest, nscores):
    """(bp_raw / BINPACK_MAX + rest) / nscores (see _binpack_plus)."""
    return _binpack_plus(bp_raw, rest) / nscores


def _score_preempt(bp_raw, rest, pscore, nscores):
    """A preempting node's score, (binpack + rest + pscore) / (nscores +
    1) (rank.go:545-565 plus the preemption score term)."""
    return (_binpack_plus(bp_raw, rest) + pscore) / (nscores + 1.0)


def _distance(need_c, need_m, need_d, used_c, used_m, used_d):
    """basicResourceDistance (preemption.go:611): a component is 0 where
    its need is <= 0. XLA contracts the sum of squares into
    fma(dd, dd, fma(dc, dc, dm * dm)); so does this."""
    def comp(need, used):
        return torch.where(need > 0, (need - used) / need.clamp_min(1e-9),
                           torch.zeros((), dtype=used.dtype,
                                       device=used.device))

    dc = comp(need_c, used_c)
    dm = comp(need_m, used_m)
    dd = comp(need_d, used_d)
    return _sqrt(_fma(dd, dd, _fma(dc, dc, dm * dm)))


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root, as XLA and the kernels take it:
    torch.sqrt on the card; numpy's on the CPU, where torch.sqrt misses
    the correctly rounded result in about 0.7% of inputs."""
    if x.device.type != "cpu":
        return torch.sqrt(x)
    return torch.from_numpy(np.sqrt(x.contiguous().numpy()))


def _f64(bits: int) -> float:
    return struct.unpack("<d", struct.pack("<Q", bits))[0]


# XLA's CPU exp (its elemental emitter), with the multiply-adds LLVM
# fuses on x86: float64 a rational approximation after a two-constant
# ln 2 reduction; float32 Cephes' degree-5 polynomial.
_EXP64 = dict(lo=_f64(0xC086232BDD7ABCD2), hi=_f64(0x40862E42FEFA39EF),
              log2e=_f64(0x3FF71547652B82FE), c1=_f64(0x3FE62E4000000000),
              c2=_f64(0x3EB7F7D1CF79ABCA), p0=_f64(0x3F2089CDD5E44BE8),
              p1=_f64(0x3F9F06D10CCA2C7E), q0=_f64(0x3EC92EB6BC365FA0),
              q1=_f64(0x3F64AE39B508B6C0), q2=_f64(0x3FCD17099887E074))
_EXP32 = dict(lo=np.float32(_f64(0xC055F33340000000)),
              hi=np.float32(_f64(0x4056333340000000)),
              log2e=np.float32(_f64(0x3FF7154760000000)),
              c1=np.float32(_f64(0x3FE6300000000000)),
              c2=np.float32(_f64(0xBF2BD01060000000)),
              poly=tuple(np.float32(_f64(b)) for b in (
                  0x3F2A0D2CE0000000, 0x3F56E879C0000000,
                  0x3F81112100000000, 0x3FA5553820000000,
                  0x3FC5555540000000)) + (np.float32(0.5),))


@functools.lru_cache(maxsize=1 << 16)
def _xla_exp(x: float, f64: bool) -> float:
    """One value of XLA's CPU exp, in float64 or float32."""
    lib = _libm()
    if f64:
        c, fma = _EXP64, lib.fma
        if x < c["lo"]:
            return 0.0
        if x > c["hi"]:
            return math.inf
        n = math.floor(fma(x, c["log2e"], 0.5))
        g = fma(-n, c["c2"], fma(-n, c["c1"], x))
        g2 = g * g
        p = fma(fma(g2, c["p0"], c["p1"]), g2, 1.0) * g
        q = fma(fma(fma(g2, c["q0"], c["q1"]), g2, c["q2"]), g2, 2.0)
        e = fma(p / (q - p), 2.0, 1.0)
        n = max(-2099, min(2099, int(n)))
        b = n >> 2                      # 2^n in four exact steps
        return e * 2.0 ** b * 2.0 ** b * 2.0 ** b * 2.0 ** (n - 3 * b)
    c, fma, f = _EXP32, lib.fmaf, np.float32
    xc = min(max(f(x), c["lo"]), c["hi"])
    n = min(max(f(math.floor(fma(xc, c["log2e"], 0.5))), f(-127.0)),
            f(127.0))
    r = f(fma(-n, c["c2"], f(fma(-n, c["c1"], xc))))
    y = c["poly"][0]
    for k in c["poly"][1:]:
        y = f(fma(y, r, k))
    y = f(f(fma(y, f(r * r), r)) + f(1.0))
    return float(f(y * f(2.0 ** int(n))))


def _exp(x: torch.Tensor) -> torch.Tensor:
    """exp, elementwise: torch.exp on the card (the CUDA math library's
    exp/expf, as the kernels call it); on the CPU XLA's own expansion,
    which rounds differently from libm and SLEEF in about a tenth of
    inputs, once per distinct input."""
    if x.device.type != "cpu":
        return torch.exp(x)
    return _host_map(_xla_exp, x.contiguous())


def _preempt_score(net_prio):
    """The logistic preemption score on net priority (rank.go
    preemptionScore): 1 / (1 + exp(rate * (net - origin)))."""
    d = 1.0 + _exp(PREEMPT_SCORE_RATE * (net_prio - PREEMPT_SCORE_ORIGIN))
    return torch.ones_like(d) / d


def _net_priority(evict, prio_f):
    """netPriority (rank.go) of each eviction set over the last axis: the
    largest priority plus the sum over the largest, 0 for an empty set."""
    zero = torch.zeros((), dtype=prio_f.dtype, device=prio_f.device)
    vals = torch.where(evict, prio_f, zero)
    mx = vals.max(dim=-1).values
    sm = vals.sum(dim=-1)
    return torch.where(mx > 0, mx + sm / mx.clamp_min(1e-9), zero)


def _anti(coll, count):
    """Job anti-affinity term: -(collisions + 1) / max(count, 1)."""
    return torch.where(coll > 0, -(coll + 1.0) / count.clamp_min(1.0),
                       torch.zeros_like(coll))


def _spread_boost(vidx, cnts, desired, has_targets, wfrac):
    """One spread's boost per candidate (spread.go SpreadIterator +
    evenSpreadScoreBoost; reference binpack.py _spread_score). ``vidx``
    (E, X) int value index per candidate, -1 where the node lacks the
    attribute; ``cnts`` (E, V) int current counts; ``desired`` (E, V);
    ``has_targets`` and ``wfrac`` (E, 1). Returns (E, X)."""
    dt = desired.dtype
    ar = torch.arange(vidx.shape[0], device=vidx.device)[:, None]
    missing = vidx < 0
    safe = vidx.clamp_min(0)
    current = cnts[ar, safe]
    used = current + 1
    des = desired[ar, safe]
    neg1 = torch.full_like(des, -1.0)
    boost_t = torch.where(
        des < 0.0, neg1,
        torch.where(des == 0.0, neg1,
                    (des - used.to(dt)) / des.clamp_min(1e-9) * wfrac))
    present = cnts > 0
    any_present = present.any(dim=1, keepdim=True)
    min_c = torch.where(present, cnts,
                        torch.full_like(cnts, _BIG)).min(
                            dim=1, keepdim=True).values
    max_c = torch.where(present, cnts, torch.zeros_like(cnts)).max(
        dim=1, keepdim=True).values
    min_f = min_c.to(dt)
    max_f = max_c.to(dt)
    cur_f = current.to(dt)
    even = torch.where(
        current != min_c,
        torch.where(min_c == 0, neg1,
                    (min_f - cur_f) / min_f.clamp_min(1e-9)),
        torch.where(min_c == max_c, neg1,
                    (max_f - min_f) / min_f.clamp_min(1e-9)))
    boost_e = torch.where(any_present, even, torch.zeros_like(even))
    per_node = torch.where(has_targets, boost_t, boost_e)
    return torch.where(missing, neg1, per_node)


def _select(final, fit, L):
    """The window emulation (select.go:38-77) along dim 1: up to MAX_SKIP
    low-score skips, the first L counted options, skipped options as
    fallback for the deficit. Returns (low, yielded, order, n_yielded)."""
    low = fit & (final <= SKIP_THRESHOLD)
    skip_rank = torch.cumsum(low.long(), dim=1)
    srank = skip_rank.clamp_max(MAX_SKIP)        # == cumsum(skipped)
    skipped = low & (skip_rank <= MAX_SKIP)
    cpos = torch.cumsum(fit.long(), dim=1) - srank   # == cumsum(counted)
    counted = fit & ~skipped
    window = counted & (cpos <= L)
    deficit = (L - torch.minimum(cpos[:, -1:], L)).clamp_min(0)
    fallback = skipped & (srank <= deficit)
    yielded = window | fallback
    order = torch.where(window, cpos, L + srank)
    return low, yielded, order, yielded.sum(dim=1)


def _winner(eff, yielded, order):
    """Max score over yielded candidates; ties go to the smallest window
    order (orders are unique among yielded candidates). Returns (w, best),
    (E,)."""
    best = eff.max(dim=1).values
    cand = yielded & (eff == best[:, None])
    w = torch.where(cand, order, torch.full_like(order, _BIG)).argmin(dim=1)
    return w, best
