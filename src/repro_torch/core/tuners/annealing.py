"""Simulated annealing over Hamming-1 neighbor moves.

Index-native path: the walk state is a single row; proposals come from
:meth:`CompiledSpace.random_neighbor_row` (draw-for-draw identical to the
legacy rejection scheme) or, with ``moves="alias"``, from the cached CSR
neighbor tables via O(1) alias sampling — the same move distribution as
the rejection scheme (each valid neighbor weighted by one over the moved
parameter's cardinality) reached in exactly two rng draws per proposal.
``moves="alias"`` therefore produces a *different, shorter* draw sequence:
it is seeded-reproducible but not journal-compatible with pre-existing
``moves="rejection"`` traces, which is why rejection stays the default.
"""

from __future__ import annotations

import math

from ..problem import Trial
from ..space import Config, SearchSpace
from .base import Tuner

#: neighbor-move proposal schemes
MOVES = ("rejection", "alias")


class SimulatedAnnealing(Tuner):
    name = "annealing"

    def __init__(self, space: SearchSpace, seed: int = 0,
                 t0: float = 1.0, alpha: float = 0.995,
                 relative: bool = True, moves: str = "rejection"):
        super().__init__(space, seed)
        if moves not in MOVES:
            raise ValueError(f"unknown move scheme {moves!r}; one of {MOVES}")
        self.t = t0
        self.alpha = alpha
        self.relative = relative
        self.moves = moves
        self.current: Config | None = None
        self.current_obj = math.inf
        self._proposed: Config | None = None
        self._cur_row: int | None = None
        self._proposed_row: int | None = None
        if moves == "alias":
            # alias moves are a property of the compiled CSR tables; a
            # silent rejection fallback would record non-reproducible
            # "alias" traces, so refuse instead
            if self._comp is None:
                raise ValueError(
                    "moves='alias' requires a compilable space "
                    "(CompiledSpace CSR neighbor tables)")
            self._comp.neighbor_alias()       # build the tables up front

    # -- scalar path (oracle / fallback; alias needs the compiled CSR) ---- #
    def ask_scalar(self) -> Config:
        if self.current is None:
            self._proposed = None
            return self.space.sample(self.rng)
        self._proposed = self.space.random_neighbor(self.current, self.rng)
        return self._proposed

    def tell_scalar(self, trial: Trial) -> None:
        self.t *= self.alpha
        if not trial.ok:
            return
        if self.current is None or self._proposed is None:
            self.current, self.current_obj = trial.config, trial.objective
            return
        delta = trial.objective - self.current_obj
        if self.relative and math.isfinite(self.current_obj) and self.current_obj > 0:
            delta /= self.current_obj
        if delta <= 0 or self.rng.random() < math.exp(-delta / max(self.t, 1e-9)):
            self.current, self.current_obj = trial.config, trial.objective

    # -- warm-start seam --------------------------------------------------- #
    def _adopt_warm_best(self, row: int, obj: float) -> None:
        """Anneal from the measured-best warm row (warm tells adopt
        unconditionally while no proposal is outstanding, so without this
        hook the walk would start at the *last* warm row instead)."""
        row = int(row)
        self._cur_row = row
        self.current = (self._comp.decode_row(row) if self._comp is not None
                        else self.space.from_flat_index(row))
        self.current_obj = obj
        self._proposed = None
        self._proposed_row = None

    # -- index-native path ------------------------------------------------ #
    def _ask_row(self) -> int:
        comp = self._comp
        if self._cur_row is None:
            self._proposed_row = None
            return comp.sample_row_rejection(self.rng)
        if self.moves == "alias":
            nrow = comp.sample_neighbor_alias(self._cur_row, self.rng)
            if nrow < 0:                       # degenerate row: stay put
                nrow = self._cur_row
        else:
            nrow = comp.random_neighbor_row(self._cur_row, self.rng)
        self._proposed_row = nrow
        return nrow

    def ask_rows(self, n: int) -> list[int]:
        return [self._ask_row() for _ in range(max(1, n))]

    def tell_rows(self, rows, objectives) -> None:
        for row, obj in zip(rows, objectives):
            self.t *= self.alpha
            if not math.isfinite(obj):
                continue
            if self._cur_row is None or self._proposed_row is None:
                self._cur_row, self.current_obj = int(row), obj
                continue
            delta = obj - self.current_obj
            if self.relative and math.isfinite(self.current_obj) \
                    and self.current_obj > 0:
                delta /= self.current_obj
            if delta <= 0 or self.rng.random() < math.exp(
                    -delta / max(self.t, 1e-9)):
                self._cur_row, self.current_obj = int(row), obj
