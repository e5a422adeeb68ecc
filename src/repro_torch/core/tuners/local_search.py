"""Randomized first-improvement local search with random restarts.

This is the algorithm whose behaviour the fitness-flow-graph / proportion-of-
centrality metric models (Schoonhoven et al.): walk to the first strictly
better Hamming-1 neighbor; restart from a random config at local minima.

Index-native path: the walk state is a row; the unexplored neighborhood is
a shuffled list of rows served straight from the cached CSR neighbor table
(same neighbor order as the iterator, and ``rng.shuffle`` draws depend only
on length — so the exploration sequence matches the scalar oracle exactly).
"""

from __future__ import annotations

import math

from ..problem import Trial
from ..space import Config, SearchSpace
from .base import Tuner


class LocalSearch(Tuner):
    name = "local"

    def __init__(self, space: SearchSpace, seed: int = 0,
                 best_improvement: bool = False):
        super().__init__(space, seed)
        self.best_improvement = best_improvement
        self.current: Config | None = None
        self.current_obj = math.inf
        self._pending: list[Config] = []       # unexplored neighbors
        self._best_nb: tuple[float, Config] | None = None
        self._cur_row: int | None = None
        self._pending_rows: list[int] = []
        self._best_nb_row: tuple[float, int] | None = None

    # -- warm-start seam --------------------------------------------------- #
    def _adopt_warm_best(self, row: int, obj: float) -> None:
        """Walk from the measured-best warm row.  Warm tells already moved
        the walk on first-improvement order; re-adopting is skipped when the
        walk is already there (the neighborhood shuffle is a draw)."""
        row = int(row)
        if self._comp is not None:
            if self._cur_row == row:
                return
            self._cur_row, self.current_obj = row, obj
            self._fill_neighbor_rows()
        else:
            cfg = self.space.from_flat_index(row)
            if self.current is not None \
                    and self.space.flat_index(self.current) == row:
                return
            self.current, self.current_obj = cfg, obj
            self._fill_neighbors()

    # -- scalar path (oracle / fallback) ---------------------------------- #
    def _restart(self) -> Config:
        self.current = None
        self.current_obj = math.inf
        self._pending = []
        self._best_nb = None
        return self.space.sample(self.rng)

    def ask_scalar(self) -> Config:
        if self.current is None:
            return self._restart()
        if not self._pending:
            # neighborhood exhausted
            if self.best_improvement and self._best_nb is not None \
                    and self._best_nb[0] < self.current_obj:
                obj, cfg = self._best_nb
                self.current, self.current_obj = cfg, obj
                self._fill_neighbors()
                if self._pending:
                    return self._pending.pop()
            return self._restart()
        return self._pending.pop()

    def _fill_neighbors(self) -> None:
        # CSR neighbor-table path when compiled (same list, same order, so
        # the shuffled exploration sequence matches the iterator path)
        self._pending = self.space.neighbors_list(self.current)
        self.rng.shuffle(self._pending)
        self._best_nb = None

    def tell_scalar(self, trial: Trial) -> None:
        if self.current is None:
            if trial.ok:
                self.current, self.current_obj = trial.config, trial.objective
                self._fill_neighbors()
            return
        if not trial.ok:
            return
        if self.best_improvement:
            if self._best_nb is None or trial.objective < self._best_nb[0]:
                self._best_nb = (trial.objective, trial.config)
            return
        if trial.objective < self.current_obj:    # first improvement: move
            self.current, self.current_obj = trial.config, trial.objective
            self._fill_neighbors()

    # -- index-native path ------------------------------------------------ #
    def _restart_row(self) -> int:
        self._cur_row = None
        self.current_obj = math.inf
        self._pending_rows = []
        self._best_nb_row = None
        return self._comp.sample_row_rejection(self.rng)

    def _fill_neighbor_rows(self) -> None:
        rows = self._comp.neighbor_rows(self._cur_row)
        self._pending_rows = [int(r) for r in rows] if rows is not None else []
        self.rng.shuffle(self._pending_rows)
        self._best_nb_row = None

    def _ask_row(self) -> int:
        if self._cur_row is None:
            return self._restart_row()
        if not self._pending_rows:
            if self.best_improvement and self._best_nb_row is not None \
                    and self._best_nb_row[0] < self.current_obj:
                obj, row = self._best_nb_row
                self._cur_row, self.current_obj = row, obj
                self._fill_neighbor_rows()
                if self._pending_rows:
                    return self._pending_rows.pop()
            return self._restart_row()
        return self._pending_rows.pop()

    def ask_rows(self, n: int) -> list[int]:
        return [self._ask_row() for _ in range(max(1, n))]

    def tell_rows(self, rows, objectives) -> None:
        for row, obj in zip(rows, objectives):
            row = int(row)
            if self._cur_row is None:
                if math.isfinite(obj):
                    self._cur_row, self.current_obj = row, obj
                    self._fill_neighbor_rows()
                continue
            if not math.isfinite(obj):
                continue
            if self.best_improvement:
                if self._best_nb_row is None or obj < self._best_nb_row[0]:
                    self._best_nb_row = (obj, row)
                continue
            if obj < self.current_obj:            # first improvement: move
                self._cur_row, self.current_obj = row, obj
                self._fill_neighbor_rows()
