"""Build, load and launch the port's CUDA kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, bound through ``ctypes``
(no PyTorch headers, so a build takes seconds). The libraries go to
``build/nomad_tpu_torch/<hash>/`` under the repository root, keyed by a
hash of the sources and flags, so an edit rebuilds and an unchanged tree
reuses the last build. Sources are built at first launch, all at once,
one ``nvcc`` process per source; nothing is compiled at import.

Numerics: ``-fmad=false`` keeps every ``a*b + c`` as a rounded multiply
and a rounded add, as the plain PyTorch versions compute it; there is no
``--use_fast_math``, and division and square root stay IEEE-rounded.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

import torch

from . import jitcheck

PKG_DIR = Path(__file__).resolve().parent
CSRC = PKG_DIR / "csrc"
BUILD_ROOT = PKG_DIR.parent / "build" / "nomad_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-prec-div=true", "-prec-sqrt=true",
    "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int


class Kernel:
    """One hand-written kernel: its source, the TPU program it replaces,
    its C entry points per dtype, and ``launches``, the count of the
    launches made through ``launch`` (exact under concurrent dispatches:
    ``count_launch`` bumps it under a lock).

    Every entry point takes its tensors as one array of device pointers
    and its ints as one int array, each in the C function's order, then
    the stream: ``int fn(void* const* ptrs, int n_ptrs, const int* dims,
    int n_dims, void* stream)``, returning a cudaError_t."""

    def __init__(self, name: str, source: str, replaces: str,
                 symbols: Dict[torch.dtype, str],
                 cluster_symbol: Optional[str] = None):
        self.name = name
        self.source = source            # file name under csrc/
        self.replaces = replaces
        self.symbols = symbols
        # a cluster kernel's ``int fn(void)``: the thread-block cluster
        # size its last launch used
        self.cluster_symbol = cluster_symbol
        self.launches = 0
        self._count_lock = threading.Lock()
        self._fns: Dict[torch.dtype, object] = {}
        self._lib = None
        # (library, dtype) entry points bound since the last bind(): a
        # second bind of one is a steady-state rebuild (jitcheck)
        self._bound: set = set()

    def bind(self, lib: ctypes.CDLL) -> None:
        """Launch from ``lib`` (a build of another source tree, for A/B
        timing) instead of the package's own build."""
        self._lib = lib
        self._fns = {}
        self._bound = set()

    def lib(self):
        return self._lib if self._lib is not None else load()[self.source]

    def last_cluster(self) -> int:
        """The cluster size of the kernel's last launch (0 before any)."""
        fn = getattr(self.lib(), self.cluster_symbol)
        fn.argtypes = []
        fn.restype = ctypes.c_int
        return int(fn())

    def _fn(self, dtype: torch.dtype):
        fn = self._fns.get(dtype)
        if fn is None:
            lib = self.lib()
            if jitcheck._ACTIVE:
                key = (id(lib), dtype)
                jitcheck.note_build(f"kernel:{self.name}",
                                    ("bind", str(dtype)),
                                    held=key in self._bound)
                self._bound.add(key)
            fn = getattr(lib, self.symbols[dtype])
            fn.argtypes = [_P, _I, _P, _I, _P]
            fn.restype = ctypes.c_int
            self._fns[dtype] = fn
        return fn

    def count_launch(self) -> None:
        """Add one launch to ``launches``; pipelined dispatches launch
        from several threads at once, and ``+=`` alone can lose one."""
        with self._count_lock:
            self.launches += 1

    def reset_count(self) -> None:
        with self._count_lock:
            self.launches = 0

    def launch(self, dtype: torch.dtype, tensors, ints):
        """Launch on the current stream with the tensors' device pointers
        (an int in ``tensors`` is taken as a device pointer already; the
        first entry must be a tensor) and the int arguments; raise if the
        launch was refused."""
        if dtype not in self.symbols:
            raise TypeError(f"{self.name}: no kernel for {dtype}")
        dev = tensors[0].device
        ptrs = (ctypes.c_void_p * len(tensors))(
            *[t if type(t) is int else t.data_ptr() for t in tensors])
        vals = (ctypes.c_int * len(ints))(*[int(v) for v in ints])
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = self._fn(dtype)(ptrs, len(tensors), vals, len(ints),
                                 stream)
        if rc != 0:
            raise RuntimeError(f"{self.name}: CUDA launch failed with "
                               f"cudaError_t {rc}")
        self.count_launch()
        if jitcheck._ACTIVE:
            jitcheck.note_launch(self.name, dtype, tensors, ints,
                                 host_setup=self.cluster_symbol is not None)


WAVE_COMPACT = Kernel(
    "wave_compact", "wave_compact.cu",
    "nomad_tpu/solver/binpack.py:1572 _solve_wave_compact_impl",
    {torch.float32: "nt_wave_compact_f32",
     torch.float64: "nt_wave_compact_f64"})

WAVE_BLOCK = Kernel(
    "wave_block", "wave_block.cu",
    "nomad_tpu/solver/binpack.py:1806 _solve_wave_block_impl",
    {torch.float32: "nt_wave_block_f32",
     torch.float64: "nt_wave_block_f64"})

DENSE_SCAN = Kernel(
    "dense_scan", "dense_scan.cu",
    "nomad_tpu/solver/binpack.py:652 _solve_placements_impl",
    {torch.float32: "nt_dense_scan_f32",
     torch.float64: "nt_dense_scan_f64"}, "nt_dense_scan_cluster")

SYSTEM_FIT = Kernel(
    "system_fit", "system_fit.cu",
    "nomad_tpu/solver/binpack.py:1341 _solve_system_impl",
    {torch.float32: "nt_system_fit_f32",
     torch.float64: "nt_system_fit_f64"})

WAVE_PREEMPT = Kernel(
    "wave_preempt", "wave_preempt.cu",
    "nomad_tpu/solver/binpack.py:2293 _solve_wave_preempt_impl",
    {torch.float32: "nt_wave_preempt_f32",
     torch.float64: "nt_wave_preempt_f64"})

DENSE_PREEMPT = Kernel(
    "dense_preempt", "dense_preempt.cu",
    "nomad_tpu/solver/binpack.py:732 _solve_placements_preempt_impl",
    {torch.float32: "nt_dense_preempt_f32",
     torch.float64: "nt_dense_preempt_f64"}, "nt_dense_preempt_cluster")

# The reference's LP is float32 on every backend (lpq.py builds its
# inputs and its dual prices in float32 whatever the lane dtype), so this
# kernel has a float32 build only.
LP_RELAX = Kernel(
    "lp_relax", "lp_relax.cu",
    "nomad_tpu/solver/lpq.py:215 _lp_solve_body",
    {torch.float32: "nt_lp_relax_f32"})

def _by_size(prefix: str) -> Dict[torch.dtype, str]:
    """A raw-bits kernel's entry points: one per element size, shared by
    every dtype of that size."""
    return {dt: f"{prefix}_{torch.empty(0, dtype=dt).element_size()}"
            for dt in (torch.bool, torch.uint8, torch.int8, torch.int16,
                       torch.float16, torch.bfloat16, torch.int32,
                       torch.float32, torch.int64, torch.float64)}


# The delta scatter moves raw bits: one entry point per element size.
DELTA_SCATTER = Kernel(
    "delta_scatter", "delta_scatter.cu",
    "nomad_tpu/solver/constcache.py:249 _delta_scatter_program",
    _by_size("nt_delta_scatter"))

WAVEFRONT = Kernel(
    "wavefront", "wavefront.cu",
    "nomad_tpu/solver/binpack.py:1154 _solve_wavefront_impl",
    {torch.float32: "nt_wavefront_f32",
     torch.float64: "nt_wavefront_f64"})

# The mesh programs (nomad_tpu/parallel/mesh.py). The node-sharded dense
# scan and the lane-sharded LP are persistent: one launch runs every step
# of every cell of the grid on one card (solver/exchange.py launch), the
# cells meeting through flagged slots (csrc/mesh_exchange.cuh). The
# coordinate scatter writes every cell of one card in one launch.
DENSE_SHARD = Kernel(
    "dense_shard", "dense_shard.cu",
    "nomad_tpu/parallel/mesh.py:251 mesh_solve_fn",
    {torch.float32: "nt_dense_shard_f32",
     torch.float64: "nt_dense_shard_f64"}, "nt_dense_shard_cluster")

COORD_SCATTER = Kernel(
    "coord_scatter", "delta_scatter.cu",
    "nomad_tpu/parallel/mesh.py:279 mesh_delta_scatter_fn",
    _by_size("nt_coord_scatter"))

LP_SHARD = Kernel(
    "lp_shard", "lp_relax.cu",
    "nomad_tpu/parallel/mesh.py:452 mesh_lpq_fn",
    {torch.float32: "nt_lp_shard_f32"})

KERNELS = (WAVE_BLOCK, WAVE_COMPACT, DENSE_SCAN, SYSTEM_FIT, WAVE_PREEMPT,
           DENSE_PREEMPT, LP_RELAX, DELTA_SCATTER, WAVEFRONT, DENSE_SHARD,
           COORD_SCATTER, LP_SHARD)


def reset_launches() -> None:
    for k in KERNELS:
        k.reset_count()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or PATH)")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu"))


def build_dir() -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16]


_LOCK = threading.Lock()
_LIBS: Optional[Dict[str, ctypes.CDLL]] = None


def build() -> Dict[str, object]:
    """Compile every csrc/*.cu that is missing from the build directory,
    one nvcc process per source, all started together. Returns
    {"dir", "seconds", "built", "log"}; raises with nvcc's output if a
    build fails."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for src in _sources():
        lib = out_dir / (src.stem + ".so")
        if lib.exists():
            continue
        tmp = out_dir / f"{src.stem}.{os.getpid()}.tmp.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(src)]
        procs.append((src, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    if procs and jitcheck._ACTIVE:
        # compiling after the process's first launch: a rebuild
        jitcheck.note_build("kernels.build", out_dir.name,
                            held=jitcheck.launched())
    log = []
    failed = []
    for src, lib, tmp, proc in procs:
        text, _ = proc.communicate()
        log.append(f"== {src.name}\n{text}")
        if proc.returncode != 0:
            failed.append(src.name)
        else:
            os.replace(tmp, lib)
    if procs:
        (out_dir / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
    return {"dir": str(out_dir), "seconds": time.perf_counter() - t0,
            "built": [p[0].name for p in procs], "log": "\n".join(log)}


def load() -> Dict[str, ctypes.CDLL]:
    """Build if needed and load every kernel library (once per process)."""
    global _LIBS
    with _LOCK:
        if _LIBS is None:
            if jitcheck._ACTIVE:
                # loading after the process's first launch: a rebuild
                jitcheck.note_build("kernels.load", build_dir().name,
                                    held=jitcheck.launched())
            build()
            out_dir = build_dir()
            _LIBS = {src.name: ctypes.CDLL(str(out_dir / (src.stem + ".so")))
                     for src in _sources()}
        return _LIBS
