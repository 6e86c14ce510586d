"""The host half of the mesh kernels' exchange protocol
(csrc/mesh_exchange.cuh).

A mesh dispatch launches one persistent kernel per card (the node-sharded
scan, csrc/dense_shard.cu; the lane-sharded LP, csrc/lp_relax.cu
nt_lp_shard_f32), and the cells of the grid meet through flagged slots in
an exchange area per group. This module builds what those launches take:

  * the areas, laid out as the kernels lay them out (``shard_views``,
    ``lp_views``: the plain phases of solver/dense.py and solver/lpq.py
    read and write the same views, so the plain route needs no copies
    between cells either): in the card's memory when a group's cells
    share one card, in pinned host memory (which every card maps at the
    same address) when they span cards or the caller asks for it;
  * the error word a timed-out wait writes, and ``check``, which the call
    that reads a dispatch's results runs: it raises ``ExchangeTimeout``;
  * the device table of the cells' pointers, shipped through pinned
    memory and counted as the ``mesh`` group's payload;
  * ``launch``: every persistent mesh launch of a card goes on that card's
    one mesh stream, ordered after and before the caller's stream, and
    the launches of one dispatch are enqueued under one lock in card
    order, so no two persistent launches ever spin against each other.
"""
from __future__ import annotations

import collections
import threading
from typing import Dict, List, Sequence

import torch

from .. import jitcheck
from . import resident, xferobs

# mesh_exchange.cuh's constants (tests/test_torch_mesh_exchange.py reads
# the header and holds these to it)
PARITIES = 2            # kParities: slot copies, alternating by step
SHARD_POINTS = 2        # kShardPoints: counts, then the record
LP_POINTS = 1           # kLpPoints: the row statistics
CNT_WORDS = 2           # kCntWords: fit, low
STAT_ROWS = 2           # kStatRows: row max, row sum
ERR_WORDS = 4           # kErrWords: code, step, cell, lane

ERRORS = {1: "a peer's counts", 2: "a peer's record",
          3: "a peer's row statistics", 4: "a block of the cell"}

# The default wait budget: longer than any dispatch the mesh kernels run,
# short enough that a lost peer frees the card. clock64 counts SM cycles;
# the H100's top SM clock is 1.98 GHz, so a budget counted at 2 GHz lasts
# at least this long.
WAIT_BUDGET_S = 10.0
_CYCLES_PER_S = 2.0e9


class ExchangeTimeout(RuntimeError):
    """A wait of a persistent mesh kernel ran out its budget: a peer of
    its group never published. Carries (code, step, cell, lane)."""

    def __init__(self, code: int, step: int, cell: int, lane: int):
        self.code, self.step, self.cell, self.lane = code, step, cell, lane
        super().__init__(
            f"mesh exchange: cell {cell} (lane {lane}, step {step}) waited "
            f"out its budget for {ERRORS.get(code, f'code {code}')}")


def budget_units(seconds: float = None) -> int:
    """A wait budget in the kernels' units of 1,024 SM cycles."""
    s = WAIT_BUDGET_S if seconds is None else float(seconds)
    return int(min(2 ** 31 - 1, max(1, s * _CYCLES_PER_S / 1024)))


def zeros(n: int, device: torch.device, host: bool) -> torch.Tensor:
    """A zeroed int32 buffer of ``n`` words: pinned host memory when
    ``host``, else on ``device``."""
    if host:
        return torch.zeros(n, dtype=torch.int32, pin_memory=True)
    return torch.zeros(n, dtype=torch.int32, device=device)


def host_form(devices: Sequence[torch.device], force: bool = False) -> bool:
    """Whether a group (or a dispatch's error word) over ``devices`` lives
    in pinned host memory: on cards, when ``force``d or when they span
    several cards."""
    devs = {str(torch.device(d)) for d in devices}
    return any(d.startswith("cuda") for d in devs) and (force
                                                         or len(devs) > 1)


# --------------------------------------------------------------------------
# Layouts (mesh_exchange.cuh "Area layouts").

def shard_area_words(n_par: int, E: int, W: int) -> int:
    return PARITIES * n_par * E * (CNT_WORDS + W) + n_par * E


def shard_views(area: torch.Tensor, n_par: int, E: int, W: int):
    """A scan group's area as (cnt (PARITIES, n_par, E, CNT_WORDS), rec
    (PARITIES, n_par, E, W), seq (n_par, E)), int32 views."""
    a = PARITIES * n_par * E * CNT_WORDS
    b = a + PARITIES * n_par * E * W
    return (area[:a].view(PARITIES, n_par, E, CNT_WORDS),
            area[a:b].view(PARITIES, n_par, E, W),
            area[b:b + n_par * E].view(n_par, E))


def lp_area_words(G: int, L: int) -> int:
    return PARITIES * STAT_ROWS * L + G


def lp_views(area: torch.Tensor, G: int, L: int):
    """An LP group's area as (stats (PARITIES, STAT_ROWS, L) float32,
    seq (G,) int32) views."""
    a = PARITIES * STAT_ROWS * L
    return (area[:a].view(torch.float32).view(PARITIES, STAT_ROWS, L),
            area[a:a + G])


# --------------------------------------------------------------------------
# The error word.

def error_word(device: torch.device, host: bool) -> torch.Tensor:
    return zeros(ERR_WORDS, device, host)


def check(err) -> None:
    """Raise ExchangeTimeout if the dispatch's error word is set. Call it
    where the results are read back: the read-back has synchronized."""
    if err is None:
        return
    # the error word rides the grid's read-back (mesh.mesh_solve and the
    # LP's reads have synchronized): no second wait for the card
    with jitcheck.sanctioned_fetch("mesh"):
        code, step, cell, lane = (int(x) for x in err.cpu().tolist())
    if code:
        raise ExchangeTimeout(code, step, cell, lane)


# --------------------------------------------------------------------------
# Launching.

_LOCK = threading.Lock()
_STREAMS: Dict[str, torch.cuda.Stream] = {}
# pinned buffers a launch in flight still reads: released once its event
# has completed (the host allocator only tracks buffers copied through
# PyTorch, not ones a kernel reads by address)
_HELD: collections.deque = collections.deque()


def mesh_stream(device: torch.device) -> "torch.cuda.Stream":
    key = str(device)
    st = _STREAMS.get(key)
    if st is None:
        st = _STREAMS[key] = torch.cuda.Stream(device=device)
    return st


def cell_table(rows: List[List[int]], device: torch.device) -> torch.Tensor:
    """The cells' pointer rows as one (n_cells, words) int64 table on
    ``device``, shipped from pinned memory without a host sync."""
    host = torch.tensor(rows, dtype=torch.int64).pin_memory()
    nbytes = host.numel() * host.element_size()
    xferobs.note_payload("mesh", nbytes)
    resident.note_dispatch_bytes(nbytes)
    return host.to(device, non_blocking=True)


def pinned(tensors) -> list:
    """The host-memory buffers among ``tensors``, each once (what
    ``launch`` must hold)."""
    return list({id(t): t for t in tensors if not t.is_cuda}.values())


def _reap() -> None:
    while _HELD and all(ev.query() for ev in _HELD[0][0]):
        _HELD.popleft()


def launch(launches, hold: Sequence[torch.Tensor] = ()) -> None:
    """Enqueue one dispatch's persistent launches, ``launches`` a list of
    (device, fn): on each card's mesh stream, after the work the caller's
    stream holds and before what it enqueues next, under the lock, in
    card order. ``hold``: pinned buffers the launches read, kept until
    they have run."""
    with _LOCK:
        _reap()
        events = []
        for dev, fn in sorted(launches, key=lambda x: str(x[0])):
            cur = torch.cuda.current_stream(dev)
            ms = mesh_stream(dev)
            ms.wait_stream(cur)
            with torch.cuda.stream(ms):
                fn()
            cur.wait_stream(ms)
            if hold:
                ev = torch.cuda.Event()
                ev.record(ms)
                events.append(ev)
        if events:
            _HELD.append((events, list(hold)))
