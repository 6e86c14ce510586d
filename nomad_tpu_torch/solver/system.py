"""System-job fit: the system_fit kernel, its plain PyTorch version, and
the wrapper that picks between them (port of nomad_tpu/solver/binpack.py
_solve_system_impl).

A system or sysbatch eval runs one Stack.Select per node with that node
as the only candidate (scheduler_system.go), so every node is fit and
scored on its own against the initial usage: no window, no carry, no
distinct-hosts, affinity, spread or anti-affinity terms (stack.go:201
SystemStack). The score is the normalized binpack fitness alone. Like the
reference, only row 0 of the placement batch is read: a system task
group asks the same of every node.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..device import DeviceLike, default_dtype_name, resolve_device
from .binpack import BINPACK_MAX, NodeConst, NodeState, PlacementBatch
from .dense import _field_dtype, lane_tensors
from .scoring import _binpack_raw, _fma

# (tree, field) order of the tensor pointers nt_system_fit_* takes
# (csrc/system_fit.cu unpacks them in this order)
SYSTEM_ARGS = (
    ("const", "cpu_cap"), ("const", "mem_cap"), ("const", "disk_cap"),
    ("const", "feasible"), ("const", "mhz_per_core"),
    ("state", "used_cpu"), ("state", "used_mem"), ("state", "used_disk"),
    ("state", "static_free"), ("state", "dyn_avail"),
    ("state", "cores_free"),
    ("batch", "ask_cpu"), ("batch", "ask_mem"), ("batch", "ask_disk"),
    ("batch", "n_dyn_ports"), ("batch", "has_static"),
    ("batch", "ask_cores"),
)


def system_fit_plain(const: NodeConst, init: NodeState,
                     batch: PlacementBatch, *, spread_alg: bool):
    """Plain PyTorch version of the system fit over E stacked lanes.
    Returns (fit (E, N) bool, score (E, N))."""
    dt = const.cpu_cap.dtype
    ask_cpu = batch.ask_cpu[:, :1]
    has_cores = const.mhz_per_core.shape[-1] > 0
    if has_cores:
        ask_cores = batch.ask_cores[:, :1]
        eff_cpu = _fma(ask_cores.to(dt), const.mhz_per_core, ask_cpu)
    else:
        eff_cpu = ask_cpu
    new_cpu = init.used_cpu + eff_cpu
    new_mem = init.used_mem + batch.ask_mem[:, :1]
    new_disk = init.used_disk + batch.ask_disk[:, :1]
    feas = (const.feasible
            & (init.dyn_avail >= batch.n_dyn_ports[:, :1])
            & (init.static_free | ~batch.has_static[:, :1]))
    if has_cores:
        feas = feas & (init.cores_free >= ask_cores)
    fit = (feas & (new_cpu <= const.cpu_cap) & (new_mem <= const.mem_cap)
           & (new_disk <= const.disk_cap))
    free_cpu = 1.0 - new_cpu / const.cpu_cap.clamp_min(1e-9)
    free_mem = 1.0 - new_mem / const.mem_cap.clamp_min(1e-9)
    # XLA lowers clip(raw) / 18 to a multiply by the rounded reciprocal
    recip = torch.full((), 1.0, dtype=dt,
                       device=new_cpu.device) / BINPACK_MAX
    return fit, _binpack_raw(free_cpu, free_mem, spread_alg) * recip


def system_fit(const: NodeConst, init: NodeState, batch: PlacementBatch,
               *, spread_alg: bool):
    """System fit over E stacked lanes of tensors on one device: the plain
    version for CPU tensors, the system_fit kernel for CUDA tensors.
    Returns (fit (E, N) bool, score (E, N))."""
    dt = const.cpu_cap.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"cpu_cap dtype {dt} is not float32/float64")
    dev = const.cpu_cap.device
    E, N = const.cpu_cap.shape
    trees = {"const": const, "state": init, "batch": batch}
    has_cores = const.mhz_per_core.shape[-1] > 0
    for tree, f in SYSTEM_ARGS:
        t = getattr(trees[tree], f)
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{tree}.{f} must be a torch.Tensor")
        if t.device != dev:
            raise ValueError(f"{tree}.{f} is on {t.device}, expected {dev}")
        if f in ("mhz_per_core", "cores_free", "ask_cores") and not has_cores:
            continue
        if t.dtype != _field_dtype(f, dt):
            raise TypeError(f"{tree}.{f} has dtype {t.dtype}, expected "
                            f"{_field_dtype(f, dt)}")
        if t.shape[0] != E or t.dim() != 2 or (tree != "batch"
                                               and t.shape[1] != N):
            raise ValueError(f"{tree}.{f} has shape {tuple(t.shape)}, "
                             f"expected ({E}, {N}) (batch: ({E}, P))")
    if batch.ask_cpu.shape[1] < 1:
        raise ValueError("the batch needs at least one placement row")
    if dev.type == "cpu":
        return system_fit_plain(const, init, batch, spread_alg=spread_alg)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    P = batch.ask_cpu.shape[1]
    fit = torch.empty((E, N), dtype=torch.bool, device=dev)
    score = torch.empty((E, N), dtype=dt, device=dev)
    ptrs = [getattr(trees[tree], f).contiguous() for tree, f in SYSTEM_ARGS]
    kernels.SYSTEM_FIT.launch(
        dt, ptrs + [fit, score],
        [E, N, P, int(has_cores), int(bool(spread_alg))])
    return fit, score


def solve_system(const, init, batch, *, spread_alg: bool,
                 dtype_name=None, device: DeviceLike = None):
    """System fit of ONE lane's numpy tables (node axis (N,), placement
    axis (P,), as the reference's solve_system takes them) on ``device``
    (default ``cuda``; no card raises). Returns (fit (N,) bool, score
    (N,)) tensors on that device, in the lane's shuffled order."""
    dev = resolve_device(device)
    dtype_name = default_dtype_name(dev, dtype_name)

    def row(tree):
        return type(tree)(*(np.asarray(a)[None] for a in tree))

    c, s, b = lane_tensors(row(const), row(init), row(batch),
                           dtype_name=dtype_name, device=dev)
    fit, score = system_fit(c, s, b, spread_alg=spread_alg)
    return fit[0], score[0]
