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

from types import SimpleNamespace

import numpy as np
import torch

from .. import jitcheck, kernels
from ..device import DeviceLike, default_dtype_name, resolve_device
from . import resident, xferobs
from .binpack import BINPACK_MAX, NodeConst, NodeState, PlacementBatch
from .dense import _field_dtype
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


@jitcheck.plain_version
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


# The field table, built once: per SYSTEM_ARGS entry its tree's index in
# (const, state, batch), its name, its kind ("f" the lane's float dtype,
# "i" int32, "b" bool) and whether only a core-asking lane reads it.
_TREES = ("const", "state", "batch")
_CORE_FIELDS = ("mhz_per_core", "cores_free", "ask_cores")
_KINDS = {torch.int32: "i", torch.bool: "b"}
_TABLE = tuple(
    (_TREES.index(tree), f, _KINDS.get(_field_dtype(f, torch.float64), "f"),
     f in _CORE_FIELDS) for tree, f in SYSTEM_ARGS)
_CPU_CAP, _MHZ, _ASK_CPU = 0, 4, 11          # positions in SYSTEM_ARGS
_ITEMSIZE = {torch.float32: 4, torch.float64: 8}


def _tables_of(const, init, batch):
    """The 17 tables the kernel reads, in SYSTEM_ARGS order."""
    trees = (const, init, batch)
    return [getattr(trees[ti], f) for ti, f, _, _ in _TABLE]


def _trees_of(tables):
    """Attribute views of the tables, for the plain version."""
    trees = ({}, {}, {})
    for (ti, f, _, _), t in zip(_TABLE, tables):
        trees[ti][f] = t
    return tuple(SimpleNamespace(**d) for d in trees)


def packed_views(out: torch.Tensor, E: int, N: int, dt: torch.dtype):
    """(fit (E, N) bool, score (E, N) dt) views of one output buffer:
    the scores' bytes, then the fit flags'."""
    nb = E * N * _ITEMSIZE[dt]
    return (out[nb:].view(torch.bool).view(E, N),
            out[:nb].view(dt).view(E, N))


def _checked(tables):
    """One pass over the field table: every table a tensor on cpu_cap's
    device, of its kind's dtype and shape (node tables (E, N), batch
    tables (E, P); a core table only where the lane asks for cores).
    Returns (dtype, device, E, N, P, has_cores, the tables made
    contiguous)."""
    cap = tables[_CPU_CAP]
    if not isinstance(cap, torch.Tensor):
        raise TypeError("const.cpu_cap must be a torch.Tensor")
    dt = cap.dtype
    if dt not in _ITEMSIZE:
        raise TypeError(f"cpu_cap dtype {dt} is not float32/float64")
    if cap.dim() != 2:
        raise ValueError(f"const.cpu_cap has shape {tuple(cap.shape)}, "
                         "expected (E, N)")
    dev = cap.device
    E, N = cap.shape
    has_cores = tables[_MHZ].shape[-1] > 0
    P = tables[_ASK_CPU].shape[-1]
    if P < 1:
        raise ValueError("the batch needs at least one placement row")
    want = {"f": dt, "i": torch.int32, "b": torch.bool}
    node, row = (E, N), (E, P)
    out = []
    for (ti, f, kind, core), t in zip(_TABLE, tables):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{_TREES[ti]}.{f} must be a torch.Tensor")
        if t.device != dev:
            raise ValueError(f"{_TREES[ti]}.{f} is on {t.device}, "
                             f"expected {dev}")
        if not core or has_cores:
            if t.dtype is not want[kind]:
                raise TypeError(f"{_TREES[ti]}.{f} has dtype {t.dtype}, "
                                f"expected {want[kind]}")
            if t.shape != (row if ti == 2 else node):
                raise ValueError(
                    f"{_TREES[ti]}.{f} has shape {tuple(t.shape)}, "
                    f"expected {node} (batch: {row})")
        out.append(t if t.is_contiguous() else t.contiguous())
    return dt, dev, E, N, P, has_cores, out


def _launch(tables, dims, fit, score, spread_alg):
    """The system_fit kernel into ``fit`` and ``score`` (tensors or
    device pointers)."""
    dt, _, E, N, P, has_cores = dims
    kernels.SYSTEM_FIT.launch(
        dt, tables + [fit, score],
        [E, N, P, int(has_cores), int(bool(spread_alg))])


def system_fit_tables(tables, *, spread_alg: bool) -> torch.Tensor:
    """System fit over the 17 tables the kernel reads (SYSTEM_ARGS order:
    node tables (E, N), batch tables (E, P) of which row 0 is read), all
    on one device. Returns one uint8 buffer holding the (E, N) scores,
    then the (E, N) fit flags (``packed_views`` splits it), so a caller
    reads both back with one copy: the plain version for CPU tensors,
    the system_fit kernel for CUDA tensors."""
    *dims, tables = _checked(tables)
    dt, dev, E, N = dims[:4]
    if dev.type == "cpu":
        fit, score = system_fit_plain(*_trees_of(tables),
                                      spread_alg=spread_alg)
        return torch.cat([score.reshape(-1).view(torch.uint8),
                          fit.reshape(-1).view(torch.uint8)])
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    nb = E * N * _ITEMSIZE[dt]
    out = torch.empty(nb + E * N, dtype=torch.uint8, device=dev)
    p = out.data_ptr()
    _launch(tables, dims, p + nb, p, spread_alg)
    return out


def system_fit(const: NodeConst, init: NodeState, batch: PlacementBatch,
               *, spread_alg: bool):
    """System fit over E stacked lanes of tensors on one device: the plain
    version for CPU tensors, the system_fit kernel for CUDA tensors.
    Returns (fit (E, N) bool, score (E, N))."""
    *dims, tables = _checked(_tables_of(const, init, batch))
    dt, dev, E, N = dims[:4]
    if dev.type == "cpu":
        return system_fit_plain(*_trees_of(tables), spread_alg=spread_alg)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    fit = torch.empty((E, N), dtype=torch.bool, device=dev)
    score = torch.empty((E, N), dtype=dt, device=dev)
    _launch(tables, dims, fit, score, spread_alg)
    return fit, score


def system_tables(const, init, batch, *, dtype_name: str,
                  device: torch.device):
    """ONE lane's numpy tables (node axis (N,), placement axis (P,)) ->
    the 17 tables system_fit_tables reads, as (1, N) and (1, 1) views of
    one buffer that reaches ``device`` in one host->device copy (page-
    locked and asynchronous on a card). Only row 0 of the batch ships,
    as the reference slices it (solver/service.py solve_system). The
    upload does not go through the resident buffer set: the reference's
    system path has no content cache."""
    dt = getattr(torch, dtype_name)
    np_dt = {"f": np.dtype(dtype_name), "i": np.dtype(np.int32),
             "b": np.dtype(np.bool_)}
    trees = (const, init, batch)
    arrs, offs = [], []
    size = 0
    for ti, f, kind, _ in _TABLE:
        a = np.asarray(getattr(trees[ti], f))
        if ti == 2:
            a = a[:1]
        a = np.ascontiguousarray(a, dtype=np_dt[kind]).reshape(1, -1)
        size = -(-size // 16) * 16          # every table 16-byte aligned
        arrs.append(a)
        offs.append(size)
        size += a.nbytes
    cuda = device.type == "cuda"
    host, h = resident._host_buffer(size, cuda)
    for a, off in zip(arrs, offs):
        h[off:off + a.nbytes] = a.reshape(-1).view(np.uint8)
    buf = host.to(device, non_blocking=True) if cuda else host
    # the one upload is the system group's payload in the transfer ledger
    xferobs.note_payload("system", size)
    resident.note_dispatch_bytes(size)
    want = {"f": dt, "i": torch.int32, "b": torch.bool}
    return [buf[off:off + a.nbytes].view(want[kind]).view(a.shape)
            for (_, _, kind, _), a, off in zip(_TABLE, arrs, offs)]


def solve_system_packed(const, init, batch, *, spread_alg: bool,
                        dtype_name=None, device: DeviceLike = None):
    """System fit of ONE lane's numpy tables on ``device`` (default
    ``cuda``; no card raises): one upload, one launch. Returns (out, N,
    dtype): the packed output buffer on that device (``packed_views``
    with E = 1 splits it)."""
    dev = resolve_device(device)
    dtype_name = default_dtype_name(dev, dtype_name)
    tables = system_tables(const, init, batch, dtype_name=dtype_name,
                           device=dev)
    out = system_fit_tables(tables, spread_alg=spread_alg)
    return out, tables[_CPU_CAP].shape[1], getattr(torch, dtype_name)


def solve_system(const, init, batch, *, spread_alg: bool,
                 dtype_name=None, device: DeviceLike = None):
    """System fit of ONE lane's numpy tables (node axis (N,), placement
    axis (P,), as the reference's solve_system takes them) on ``device``
    (default ``cuda``; no card raises). Returns (fit (N,) bool, score
    (N,)) tensors on that device, in the lane's shuffled order."""
    out, N, dt = solve_system_packed(const, init, batch,
                                     spread_alg=spread_alg,
                                     dtype_name=dtype_name, device=device)
    fit, score = packed_views(out, 1, N, dt)
    return fit[0], score[0]
