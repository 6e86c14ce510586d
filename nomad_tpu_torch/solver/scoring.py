"""Score and selection helpers shared by the wave, dense and system paths
(the plain PyTorch halves of nomad_tpu/solver/binpack.py's
_binpack_score, _spread_score and _select_window).

Every expression evaluates the same IEEE operations in the same order as
XLA's lowering of the reference, so the plain versions agree with the JAX
programs to the bit on the CPU and with the CUDA kernels on the card:

  * ``clip(raw) / 18 + rest`` is one fused multiply-add by the rounded
    reciprocal of 18 (``_score``);
  * ``ask_cpu + ask_cores * mhz_per_core`` is one fused multiply-add
    (``_fma``);
  * ``10 ** x`` is libm ``pow``/``powf`` on the CPU (``_pow10``).

On the CPU the fused and libm operations go through the C library, once
per distinct input; on the card through ``torch.addcmul`` and
``torch.pow``, which the CUDA math library evaluates as the kernels do.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import functools

import numpy as np
import torch

from .binpack import BINPACK_MAX, MAX_SKIP, SKIP_THRESHOLD

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


def _score(bp_raw, rest, nscores):
    """(bp_raw / BINPACK_MAX + rest) / nscores, evaluated as XLA lowers
    the reference (rank.go:571 fitness/18): the division by the constant
    becomes a multiply by its reciprocal rounded in the working dtype, and
    that multiply and the add are one fused multiply-add (libm fma on the
    CPU, torch.addcmul on the card, fma() in the kernels)."""
    recip = torch.full((), 1.0, dtype=bp_raw.dtype,
                       device=bp_raw.device) / BINPACK_MAX
    if bp_raw.device.type == "cpu":
        r = float(recip)
        fused = _host_map(lambda x, y, f64: _libm_fma(x, r, y, f64),
                          bp_raw.contiguous(),
                          rest.expand_as(bp_raw).contiguous())
    else:
        fused = torch.addcmul(rest, bp_raw, recip)
    return fused / nscores


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
