"""Selection iterators (port of nomad_tpu/scheduler/select.py; upstream:
scheduler/select.go, with the limit constants of stack.go:13-20):
LimitIterator and MaxScoreIterator."""
from __future__ import annotations

from typing import List, Optional

from .rank import RankedNode, RankIterator

SKIP_SCORE_THRESHOLD = 0.0
MAX_SKIP = 3


class LimitIterator(RankIterator):
    """Yields at most `limit` options, skipping up to MAX_SKIP options whose
    score is <= SKIP_SCORE_THRESHOLD (upstream: select.go LimitIterator)."""

    def __init__(self, ctx, source: RankIterator, limit: int = 1,
                 skip_threshold: float = SKIP_SCORE_THRESHOLD,
                 max_skip: int = MAX_SKIP):
        self.ctx = ctx
        self.source = source
        self.limit = limit
        self.skip_threshold = skip_threshold
        self.max_skip = max_skip
        self.seen = 0
        self.skipped_nodes: List[RankedNode] = []
        self.skipped_index = 0

    def set_limit(self, limit: int) -> None:
        self.limit = limit

    def _next_option(self) -> Optional[RankedNode]:
        """Fall back to previously-skipped nodes once the source runs dry
        (upstream: select.go:62 nextOption)."""
        option = self.source.next()
        if option is None and self.skipped_index < len(self.skipped_nodes):
            option = self.skipped_nodes[self.skipped_index]
            self.skipped_index += 1
        return option

    def next(self) -> Optional[RankedNode]:
        if self.seen == self.limit:
            return None
        option = self._next_option()
        if option is None:
            return None
        if len(self.skipped_nodes) < self.max_skip:
            while (option is not None
                   and option.final_score <= self.skip_threshold
                   and len(self.skipped_nodes) < self.max_skip):
                self.skipped_nodes.append(option)
                option = self.source.next()
        self.seen += 1
        if option is None:
            return self._next_option()
        return option

    def reset(self) -> None:
        self.source.reset()
        self.seen = 0
        self.skipped_nodes = []
        self.skipped_index = 0


class MaxScoreIterator(RankIterator):
    """Consumes the chain and returns the single best option
    (upstream: select.go MaxScoreIterator)."""

    def __init__(self, ctx, source: RankIterator):
        self.ctx = ctx
        self.source = source
        self.max_option: Optional[RankedNode] = None

    def next(self) -> Optional[RankedNode]:
        if self.max_option is not None:
            return None
        best: Optional[RankedNode] = None
        while True:
            option = self.source.next()
            if option is None:
                break
            if best is None or option.final_score > best.final_score:
                best = option
        self.max_option = best
        return best

    def reset(self) -> None:
        self.source.reset()
        self.max_option = None
