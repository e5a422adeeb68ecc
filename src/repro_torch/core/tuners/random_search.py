"""Random search — the paper's reference tuner and convergence baseline."""

from __future__ import annotations

from ..space import Config
from .base import Tuner


class RandomSearch(Tuner):
    name = "random"
    max_parallel_asks = None        # asks are independent: batch freely

    def ask_scalar(self) -> Config:
        return self.space.sample(self.rng)

    def ask_rows(self, n: int) -> list[int]:
        # one rejection draw per proposal: the ``space.sample`` draw
        # sequence, minus every dict
        comp = self._comp
        return [comp.sample_row_rejection(self.rng) for _ in range(n)]
