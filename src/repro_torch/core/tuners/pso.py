"""Discrete particle swarm over encoded index vectors.

Index-native path: particles fly through *code space* directly — velocity
updates, rounding, and clipping happen on plain Python floats (identical
arithmetic, draw order, and banker's rounding as the scalar oracle below),
and the decode/satisfies round-trip per try collapses to mixed-radix row
arithmetic plus one validity-mask lookup.  No config dicts anywhere.
"""

from __future__ import annotations

import math
from collections import deque

import numpy as np

from ..problem import Trial
from ..space import Config, SearchSpace
from .base import Tuner


class ParticleSwarm(Tuner):
    name = "pso"

    def __init__(self, space: SearchSpace, seed: int = 0, n_particles: int = 12,
                 w: float = 0.6, c1: float = 1.4, c2: float = 1.4):
        super().__init__(space, seed)
        self.n = n_particles
        self.w, self.c1, self.c2 = w, c1, c2
        # asks cycle through particles; the queue pairs each in-flight ask
        # with its particle so a full swarm step can be evaluated in parallel.
        self.max_parallel_asks = n_particles
        dims = len(space.params)
        self.pos: list[list[float]] = []
        self.vel: list[list[float]] = []
        self.pbest: list[tuple[float, list[float]]] = []
        self.gbest: tuple[float, list[float]] = (math.inf, [0.0] * dims)
        self._cur = 0
        self._pending: deque[int] = deque()
        self._init_left = n_particles
        # index-native state: positions/velocities are continuous
        # relaxations of the code vectors, kept as plain-float lists (the
        # 30-try velocity loop is pure Python; numpy per-op overhead loses
        # at these widths), with pbest as a struct-of-arrays pair
        self._pos_py: list[list[float]] = []
        self._vel_py: list[list[float]] = []
        self._pbest_py: list[list[float]] = []
        self._pbest_obj = np.full(n_particles, math.inf)
        self._gbest_py: list[float] = [0.0] * dims
        self._gbest_obj = math.inf
        self._n_alive = 0

    # -- warm-start seam --------------------------------------------------- #
    def _absorb_warm_rows(self, rows, objectives) -> None:
        """Warm rows belong to no particle: absorb them as global-best
        attraction only (both path representations), leaving the particle
        queue and per-particle bests untouched — particles still initialize
        from the tuner's own rng stream."""
        from ..spacetable import CompiledSpace
        codes = CompiledSpace.codes_for(self.space, np.asarray(rows))
        for enc, obj in zip(codes.astype(np.float64), objectives):
            obj = float(obj)
            if obj < self._gbest_obj:
                self._gbest_obj = obj
                self._gbest_py = enc.tolist()
            if obj < self.gbest[0]:
                self.gbest = (obj, enc.tolist())

    def _absorb_warm_scalar(self, trial: Trial) -> None:
        obj = trial.objective if trial.ok else math.inf
        enc = [float(x) for x in self.space.encode(trial.config)]
        if obj < self.gbest[0]:
            self.gbest = (obj, list(enc))
        if obj < self._gbest_obj:
            self._gbest_obj = obj
            self._gbest_py = list(enc)

    # -- scalar path (oracle / fallback) ---------------------------------- #
    def _decode(self, vec) -> Config:
        clipped = [max(0, min(int(round(v)), p.cardinality - 1))
                   for v, p in zip(vec, self.space.params)]
        return self.space.decode(clipped)

    def ask_scalar(self) -> Config:
        if self._init_left > 0:
            cfg = self.space.sample(self.rng)
            enc = [float(i) for i in self.space.encode(cfg)]
            self.pos.append(enc)
            self.vel.append([self.rng.uniform(-1, 1) for _ in enc])
            self.pbest.append((math.inf, list(enc)))
            self._cur = len(self.pos) - 1
            self._init_left -= 1
            self._pending.append(self._cur)
            return cfg
        i = self._cur = (self._cur + 1) % self.n
        self._pending.append(i)
        for _ in range(30):
            new_v, new_p = [], []
            for d in range(len(self.space.params)):
                v = (self.w * self.vel[i][d]
                     + self.c1 * self.rng.random() * (self.pbest[i][1][d] - self.pos[i][d])
                     + self.c2 * self.rng.random() * (self.gbest[1][d] - self.pos[i][d]))
                new_v.append(v)
                new_p.append(self.pos[i][d] + v)
            cfg = self._decode(new_p)
            if self.space.satisfies(cfg):
                self.vel[i], self.pos[i] = new_v, new_p
                return cfg
            # kick with random velocity and retry
            self.vel[i] = [self.rng.uniform(-2, 2) for _ in self.vel[i]]
        return self.space.sample(self.rng)

    def tell_scalar(self, trial: Trial) -> None:
        obj = trial.objective if trial.ok else math.inf
        i = self._pending.popleft() if self._pending else self._cur
        enc = [float(x) for x in self.space.encode(trial.config)]
        if obj < self.pbest[i][0]:
            self.pbest[i] = (obj, enc)
        if obj < self.gbest[0]:
            self.gbest = (obj, enc)

    # -- index-native path ------------------------------------------------ #
    def _ask_row(self) -> int:
        comp = self._comp
        rng = self.rng
        dims = len(self.space.params)
        if self._init_left > 0:
            row = comp.sample_row_rejection(rng)
            strides = comp.py_strides
            cards = comp.py_cards
            enc = [float((row // strides[d]) % cards[d])
                   for d in range(dims)]
            i = self._n_alive
            self._pos_py.append(enc)
            self._vel_py.append([rng.uniform(-1, 1) for _ in range(dims)])
            self._pbest_py.append(list(enc))
            self._pbest_obj[i] = math.inf
            self._n_alive += 1
            self._cur = i
            self._init_left -= 1
            self._pending.append(i)
            return row
        i = self._cur = (self._cur + 1) % self.n
        self._pending.append(i)
        mask = comp.mask
        cards = comp.py_cards
        strides = comp.py_strides
        w, c1, c2 = self.w, self.c1, self.c2
        random_ = rng.random
        pos, vel = self._pos_py[i], self._vel_py[i]
        pb, gb = self._pbest_py[i], self._gbest_py
        for _ in range(30):
            # per-dim: two draws (c1 term, c2 term) in the scalar order;
            # everything in Python floats — the oracle's exact arithmetic
            new_v = [0.0] * dims
            new_p = [0.0] * dims
            row = 0
            for d in range(dims):
                p = pos[d]
                v = (w * vel[d]
                     + c1 * random_() * (pb[d] - p)
                     + c2 * random_() * (gb[d] - p))
                new_v[d] = v
                p = p + v
                new_p[d] = p
                iv = int(round(p))
                hi = cards[d] - 1
                if iv > hi:
                    iv = hi
                if iv < 0:
                    iv = 0
                row += iv * strides[d]
            if mask[row]:
                self._vel_py[i] = new_v
                self._pos_py[i] = new_p
                return row
            vel = self._vel_py[i] = [rng.uniform(-2, 2) for _ in range(dims)]
        return comp.sample_row_rejection(rng)

    def ask_rows(self, n: int) -> list[int]:
        return [self._ask_row() for _ in range(max(1, n))]

    def tell_rows(self, rows, objectives) -> None:
        from ..spacetable import CompiledSpace
        codes = CompiledSpace.codes_for(self.space, np.asarray(rows))
        for enc, obj in zip(codes.astype(np.float64), objectives):
            obj = float(obj)
            i = self._pending.popleft() if self._pending else self._cur
            if obj < self._pbest_obj[i]:
                self._pbest_obj[i] = obj
                self._pbest_py[i] = enc.tolist()
            if obj < self._gbest_obj:
                self._gbest_obj = obj
                self._gbest_py = enc.tolist()
