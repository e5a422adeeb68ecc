"""Differential evolution adapted to discrete index space (rand/1/bin).

Index-native path: the population lives as an ``int32[pop, n_params]`` code
matrix (plus plain-int list mirrors for the per-challenger arithmetic,
where Python beats numpy at these widths); donor/trial vectors use the
scalar loop's exact float math and banker's rounding, and the
decode/satisfies round-trip per challenger collapses to mixed-radix row
arithmetic plus one validity-mask lookup.
"""

from __future__ import annotations

import math
from collections import deque

import numpy as np

from ..problem import Trial
from ..space import Config, SearchSpace
from .base import Tuner, sample_positions


class DifferentialEvolution(Tuner):
    name = "diffevo"

    def __init__(self, space: SearchSpace, seed: int = 0,
                 pop_size: int = 20, f: float = 0.7, cr: float = 0.6):
        super().__init__(space, seed)
        self.pop_size = pop_size
        self.f = f
        self.cr = cr
        # each ask records which population slot its challenger targets; tells
        # consume the queue in ask order, so a whole generation of challengers
        # can be in flight at once (the batched/orchestrated protocol).
        self.max_parallel_asks = pop_size
        self.pop: list[list[int]] = []        # encoded index vectors (scalar)
        self.obj: list[float] = []
        self._targets: deque[int | None] = deque()
        # index-native population: per-slot code rows + objectives, exposed
        # as int32/float64 matrices via :attr:`pop_codes` /
        # :attr:`pop_objectives` (derived views; the challenger loop reads
        # the plain-int lists directly)
        self._pop_n = 0
        self._codes_py: list[list[int]] = []
        self._obj_py: list[float] = []

    @property
    def pop_codes(self) -> np.ndarray:
        """Struct-of-arrays view of the population: ``int32[pop, P]``."""
        return np.asarray(self._codes_py, dtype=np.int32).reshape(
            self._pop_n, len(self.space.params))

    @property
    def pop_objectives(self) -> np.ndarray:
        return np.asarray(self._obj_py, dtype=np.float64)

    # -- warm-start seam --------------------------------------------------- #
    def _absorb_warm_rows(self, rows, objectives) -> None:
        """Warm rows seed the population directly, never touching the
        ``_targets`` queue — in a pipelined session, fill asks may already
        be in flight and their queue entries must pair with *their* tells,
        not the warm batch's."""
        from ..spacetable import CompiledSpace
        codes = CompiledSpace.codes_for(self.space, np.asarray(rows))
        for enc, obj in zip(codes.tolist(), objectives):
            self._codes_py.append(enc)
            self._obj_py.append(float(obj))
            self._pop_n += 1
            if self._pop_n > self.pop_size:
                worst = max(range(self._pop_n), key=self._obj_py.__getitem__)
                self._codes_py.pop(worst)
                self._obj_py.pop(worst)
                self._pop_n = self.pop_size

    def _absorb_warm_scalar(self, trial: Trial) -> None:
        obj = trial.objective if trial.ok else math.inf
        self.pop.append(list(self.space.encode(trial.config)))
        self.obj.append(obj)
        if len(self.pop) > self.pop_size:
            worst = max(range(len(self.obj)), key=lambda j: self.obj[j])
            self.pop.pop(worst)
            self.obj.pop(worst)

    # -- scalar path (oracle / fallback) ---------------------------------- #
    def _decode(self, vec) -> Config:
        clipped = [max(0, min(int(round(v)), p.cardinality - 1))
                   for v, p in zip(vec, self.space.params)]
        return self.space.decode(clipped)

    def ask_scalar(self) -> Config:
        # warm-started runs: warm rows enter the population without an ask,
        # so the ask/tell parity the plain fill condition assumes no longer
        # holds — keep filling until the population is genuinely complete
        # (cold runs never take the extra clause: draws are untouched)
        if (len(self.pop) + len(self._targets) < self.pop_size
                or (self.warm_started and len(self.pop) < self.pop_size)):
            self._targets.append(None)
            return self.space.sample(self.rng)
        for _ in range(100):
            i = self.rng.randrange(self.pop_size)
            a, b, c = self.rng.sample(range(self.pop_size), 3)
            donor = [self.pop[a][d] + self.f * (self.pop[b][d] - self.pop[c][d])
                     for d in range(len(self.space.params))]
            jrand = self.rng.randrange(len(self.space.params))
            trial_vec = [donor[d] if (self.rng.random() < self.cr or d == jrand)
                         else self.pop[i][d]
                         for d in range(len(self.space.params))]
            cfg = self._decode(trial_vec)
            if self.space.satisfies(cfg):
                self._targets.append(i)
                return cfg
        self._targets.append(None)
        return self.space.sample(self.rng)

    def tell_scalar(self, trial: Trial) -> None:
        obj = trial.objective if trial.ok else math.inf
        enc = list(self.space.encode(trial.config))
        target = self._targets.popleft() if self._targets else None
        if target is None or target >= len(self.pop):
            self.pop.append(enc)
            self.obj.append(obj)
            if len(self.pop) > self.pop_size:
                worst = max(range(len(self.obj)), key=lambda j: self.obj[j])
                self.pop.pop(worst)
                self.obj.pop(worst)
        elif obj <= self.obj[target]:
            self.pop[target] = enc
            self.obj[target] = obj

    # -- index-native path ------------------------------------------------ #
    def _ask_row(self) -> int:
        comp = self._comp
        rng = self.rng
        # see ask_scalar: warm seeding breaks the fill parity assumption
        if (self._pop_n + len(self._targets) < self.pop_size
                or (self.warm_started and self._pop_n < self.pop_size)):
            self._targets.append(None)
            return comp.sample_row_rejection(rng)
        cards = comp.py_cards
        strides = comp.py_strides
        mask = comp.mask
        n_params = len(cards)
        f, cr = self.f, self.cr
        codes = self._codes_py
        random_ = rng.random
        randbelow = rng._randbelow      # draw-identical to randrange
        for _ in range(100):
            i = randbelow(self.pop_size)
            a, b, c = sample_positions(rng, self.pop_size, 3)
            pa, pb, pc = codes[a], codes[b], codes[c]
            pi = codes[i]
            jrand = randbelow(n_params)
            # per-dim: one coin always (the scalar comprehension evaluates
            # ``random() < cr`` before the ``or``), donor math in Python
            # floats — the oracle's exact rounding/clipping
            row = 0
            for d in range(n_params):
                if random_() < cr or d == jrand:
                    v = int(round(pa[d] + f * (pb[d] - pc[d])))
                    hi = cards[d] - 1
                    if v > hi:
                        v = hi
                    if v < 0:
                        v = 0
                else:
                    v = pi[d]
                row += v * strides[d]
            if mask[row]:
                self._targets.append(i)
                return row
        self._targets.append(None)
        return comp.sample_row_rejection(rng)

    def ask_rows(self, n: int) -> list[int]:
        return [self._ask_row() for _ in range(max(1, n))]

    def tell_rows(self, rows, objectives) -> None:
        from ..spacetable import CompiledSpace
        codes = CompiledSpace.codes_for(self.space, np.asarray(rows))
        for enc, obj in zip(codes.tolist(), objectives):
            obj = float(obj)
            target = self._targets.popleft() if self._targets else None
            n = self._pop_n
            if target is None or target >= n:
                self._codes_py.append(enc)
                self._obj_py.append(obj)
                self._pop_n = n + 1
                if self._pop_n > self.pop_size:
                    # drop the worst (first maximum, like ``max(range, key)``)
                    worst = max(range(self._pop_n),
                                key=self._obj_py.__getitem__)
                    self._codes_py.pop(worst)
                    self._obj_py.pop(worst)
                    self._pop_n = self.pop_size
            elif obj <= self._obj_py[target]:
                self._codes_py[target] = enc
                self._obj_py[target] = obj
