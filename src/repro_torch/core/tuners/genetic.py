"""Genetic algorithm: tournament selection, uniform crossover, mutation.

Index-native path: the population is a struct-of-arrays pair
(``int32[pop, n_params]`` code matrix + ``float64[pop]`` objectives, with
plain-int list mirrors for the breeding loop, where Python beats numpy at
these widths).  Breeding works on code rows with mask-lookup validity, and
steady-state survivor selection keeps the population sorted: one stable
argsort at the first overflow, then bisect-insert per tell — equivalent to
the scalar oracle's append/stable-sort/truncate, without the O(pop log pop)
per tell.  Draw-for-draw identical to the scalar dict implementation.
"""

from __future__ import annotations

import bisect
import math

import numpy as np

from ..problem import Trial
from ..space import Config, SearchSpace
from .base import Tuner, sample_positions


class GeneticAlgorithm(Tuner):
    name = "genetic"

    def __init__(self, space: SearchSpace, seed: int = 0,
                 pop_size: int = 20, mutation_rate: float = 0.15,
                 tournament: int = 3):
        super().__init__(space, seed)
        self.pop_size = pop_size
        self.mutation_rate = mutation_rate
        self.tournament = tournament
        # ask() breeds from the *current* population without mutating it, so
        # a whole generation can be asked before any tell (batched protocol);
        # telling the batch in ask order then reproduces generational GA.
        self.max_parallel_asks = pop_size
        self.pop: list[tuple[float, Config]] = []
        # index-native population: per-individual code rows + objectives,
        # exposed as int32/float64 matrices via :attr:`pop_codes` /
        # :attr:`pop_objectives` (derived views; the breeding loop reads
        # the plain-int lists directly)
        self._pop_n = 0
        self._codes_py: list[list[int]] = []
        self._obj_py: list[float] = []
        self._sorted = False

    @property
    def pop_codes(self) -> np.ndarray:
        """Struct-of-arrays view of the population: ``int32[pop, P]``."""
        return np.asarray(self._codes_py, dtype=np.int32).reshape(
            self._pop_n, len(self.space.params))

    @property
    def pop_objectives(self) -> np.ndarray:
        return np.asarray(self._obj_py, dtype=np.float64)

    # -- scalar operators (oracle / fallback) ----------------------------- #
    def _select(self) -> Config:
        k = min(self.tournament, len(self.pop))
        contenders = self.rng.sample(self.pop, k)
        return min(contenders, key=lambda t: t[0])[1]

    def _crossover(self, a: Config, b: Config) -> Config:
        return {p.name: (a if self.rng.random() < 0.5 else b)[p.name]
                for p in self.space.params}

    def _mutate(self, cfg: Config) -> Config:
        out = dict(cfg)
        for p in self.space.params:
            if self.rng.random() < self.mutation_rate:
                out[p.name] = self.rng.choice(p.values)
        return out

    def ask_scalar(self) -> Config:
        if len(self.pop) < self.pop_size:
            return self.space.sample(self.rng)   # seeding phase
        for _ in range(200):
            child = self._mutate(self._crossover(self._select(), self._select()))
            if self.space.satisfies(child):
                return child
        return self.space.sample(self.rng)

    def tell_scalar(self, trial: Trial) -> None:
        obj = trial.objective if trial.ok else math.inf
        self.pop.append((obj, trial.config))
        if len(self.pop) > self.pop_size:      # steady-state: drop the worst
            self.pop.sort(key=lambda t: t[0])
            self.pop = self.pop[: self.pop_size]

    # -- index-native operators ------------------------------------------- #
    # The SoA matrices are the canonical population; ``_rows_py``/``_obj_py``
    # mirror them as plain-int lists because the per-child breeding loop is
    # pure Python arithmetic (numpy per-op overhead dwarfs 8-element work).
    def _select_pos(self) -> int:
        # same draws as ``rng.sample(self.pop, k)``; first-minimum tie-break
        # matches ``min(contenders, key=...)``
        n = self._pop_n
        k = self.tournament
        obj = self._obj_py
        if k == 2 and n > 21:          # binary tournament, set-path regime
            randbelow = self.rng._randbelow
            j1 = randbelow(n)
            j2 = randbelow(n)
            while j2 == j1:
                j2 = randbelow(n)
            return j2 if obj[j2] < obj[j1] else j1
        cand = sample_positions(self.rng, n, min(k, n))
        best = cand[0]
        for c in cand[1:]:
            if obj[c] < obj[best]:
                best = c
        return best

    def _ask_row(self) -> int:
        comp = self._comp
        rng = self.rng
        if self._pop_n < self.pop_size:
            return comp.sample_row_rejection(rng)   # seeding phase
        cards = comp.py_cards
        strides = comp.py_strides
        mask = comp.mask
        n_params = len(cards)
        rate = self.mutation_rate
        random_ = rng.random
        randbelow = rng._randbelow      # draw-identical to rng.choice
        for _ in range(200):
            a = self._codes_py[self._select_pos()]
            b = self._codes_py[self._select_pos()]
            # uniform crossover: all P coins first (the scalar oracle's dict
            # comprehension), THEN the mutation pass (coin per param, value
            # draw right after a hit) — draw order preserved, on int codes
            child = [a[d] if random_() < 0.5 else b[d]
                     for d in range(n_params)]
            row = 0
            for d in range(n_params):
                if random_() < rate:
                    child[d] = randbelow(cards[d])
                row += child[d] * strides[d]
            if mask[row]:
                return row
        return comp.sample_row_rejection(rng)

    def ask_rows(self, n: int) -> list[int]:
        return [self._ask_row() for _ in range(max(1, n))]

    def tell_rows(self, rows, objectives) -> None:
        from ..spacetable import CompiledSpace
        codes = CompiledSpace.codes_for(self.space, np.asarray(rows))
        for c, obj in zip(codes.tolist(), objectives):
            obj = float(obj)
            n = self._pop_n
            if n < self.pop_size:             # filling phase: plain append
                self._codes_py.append(c)
                self._obj_py.append(obj)
                self._pop_n = n + 1
                continue
            if not self._sorted:
                # first overflow: the scalar oracle stable-sorts by
                # objective and truncates; afterwards the population stays
                # sorted and inserts reduce to one bisect + shift
                order = sorted(range(n), key=self._obj_py.__getitem__)
                self._codes_py = [self._codes_py[i] for i in order]
                self._obj_py = [self._obj_py[i] for i in order]
                self._sorted = True
            # append + stable sort + drop-last == bisect_right insert
            # (a tie goes after existing equals, exactly like stable sort
            # of an appended element) with the worst survivor dropped
            pos = bisect.bisect_right(self._obj_py, obj)
            if pos < self.pop_size:
                self._obj_py.insert(pos, obj)
                self._codes_py.insert(pos, c)
                del self._obj_py[-1]
                del self._codes_py[-1]
