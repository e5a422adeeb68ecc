"""Deterministic (optionally shuffled) full-grid enumeration."""

from __future__ import annotations

from ..space import Config, SearchSpace
from .base import Tuner


class GridSearch(Tuner):
    name = "grid"
    max_parallel_asks = None        # the visit order never depends on tells

    def __init__(self, space: SearchSpace, seed: int = 0, shuffle: bool = True):
        super().__init__(space, seed)
        self._shuffle = shuffle
        self._buf: list[Config] = []
        self._rows: list[int] = []
        self._pos = 0
        self._done = False
        if self._comp is not None:
            # index-native: visit the valid rows directly.  ``valid_rows``
            # order == ``enumerate`` order, and ``rng.shuffle`` draws depend
            # only on the list length, so the visit sequence is unchanged.
            self._rows = [int(r) for r in self._comp.valid_rows]
            if shuffle:
                self.rng.shuffle(self._rows)
        elif shuffle:
            self._buf = self.space.valid_configs()
            self.rng.shuffle(self._buf)
        else:
            self._iter = self.space.enumerate(constrained=True)

    def ask_rows(self, n: int) -> list[int]:
        out: list[int] = []
        for _ in range(max(1, n)):
            if self._shuffle:
                if not self._rows:
                    self._done = True
                    out.append(self._comp.sample_row_rejection(self.rng))
                else:
                    out.append(self._rows.pop())
            else:
                if self._pos < len(self._rows):
                    out.append(self._rows[self._pos])
                    self._pos += 1
                else:
                    self._done = True
                    out.append(self._comp.sample_row_rejection(self.rng))
        return out

    def ask_scalar(self) -> Config:
        if self._rows:
            # constructed while compiled, then forced scalar: serve the same
            # visit sequence from the row buffer (decode == from_flat_index)
            if self._shuffle:
                return self.space.from_flat_index(self._rows.pop())
            if self._pos < len(self._rows):
                cfg = self.space.from_flat_index(self._rows[self._pos])
                self._pos += 1
                return cfg
            self._done = True
            return self.space.sample(self.rng)
        if self._shuffle:
            if not self._buf:
                self._done = True
                return self.space.sample(self.rng)
            return self._buf.pop()
        try:
            return next(self._iter)
        except StopIteration:
            self._done = True
            return self.space.sample(self.rng)

    def finished(self) -> bool:
        return self._done
