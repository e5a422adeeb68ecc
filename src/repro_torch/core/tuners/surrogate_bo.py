"""Surrogate-model optimizer (Bayesian-optimization style).

Fits the from-scratch GBDT on observed (config, log-time) pairs, scores a
random candidate pool with an exploration bonus from the cross-tree
prediction spread (a cheap epistemic-uncertainty proxy), and asks the best
candidate.  Mirrors what SMAC3/Optuna-style tuners do on these spaces.

Batched acquisition (``batch_width > 1``) is qLCB-style: every slot scores
its own freshly sampled candidate pool under a jittered exploration weight
— slot 0 uses the base ``kappa`` (so a width-1 tuner is bit-identical to
the historical sequential implementation), later slots draw
``kappa * Exp(1)`` — and earlier slots' picks are excluded so one batch
never proposes duplicates.  All rng use follows the contract in
``tuners/base.py``: draws are consumed per proposed config, in proposal
order, so a budget-truncated final batch consumes a prefix of the stream
and resumed sessions replay the identical sequence.
"""

from __future__ import annotations

import math

import numpy as np

from ..mlmodel import GradientBoostedTrees
from ..problem import Trial
from ..space import Config, SearchSpace
from .base import Tuner


class SurrogateBO(Tuner):
    name = "surrogate_bo"

    def __init__(self, space: SearchSpace, seed: int = 0,
                 n_init: int = 16, pool: int = 256, refit_every: int = 8,
                 kappa: float = 1.0, batch_width: int = 1):
        super().__init__(space, seed)
        self.n_init = n_init
        self.pool = pool
        self.refit_every = refit_every
        self.kappa = kappa
        self.batch_width = max(1, int(batch_width))
        self.max_parallel_asks = self.batch_width
        self.X: list[tuple[int, ...]] = []
        self.y: list[float] = []
        self.model: GradientBoostedTrees | None = None
        self._since_fit = 0
        #: flat indices of every told config == compiled-space rows
        self._seen: set[int] = set()

    def _fit(self) -> None:
        if len(self.y) < max(8, self.n_init // 2):
            return
        X = np.array(self.X, dtype=np.int64)
        y = np.array(self.y)
        self.model = GradientBoostedTrees(
            n_trees=60, learning_rate=0.15, max_depth=4,
            min_samples_leaf=2, subsample=0.8, seed=self.seed).fit(X, y)
        self._since_fit = 0

    def _spread(self, X: np.ndarray) -> np.ndarray:
        """Std of late-stage per-tree increments — exploration signal."""
        m = self.model
        tail = m.trees[len(m.trees) // 2:]
        if not tail:
            return np.zeros(len(X))
        preds = np.stack([t.predict(X) for t in tail])
        return preds.std(axis=0)

    def _slot_kappa(self, slot: int) -> float:
        """Exploration weight for one batch slot.  Slot 0 draws nothing
        (bit-compat with the sequential width-1 tuner); later slots jitter
        the weight, one draw per slot in slot order."""
        if slot == 0:
            return self.kappa
        return self.kappa * self.rng.expovariate(1.0)

    # -- index-native path ------------------------------------------------ #
    def ask_rows(self, n: int) -> list[int]:
        from ..spacetable import CompiledSpace
        comp = self._comp
        rng = self.rng
        out: list[int] = []
        chosen: set[int] = set()
        for slot in range(max(1, n)):
            if len(self.y) < self.n_init or self.model is None:
                out.append(comp.sample_row_rejection(rng))
                continue
            cand: list[int] = []
            for _ in range(self.pool * 4):
                r = comp.sample_row_rejection(rng)
                if r not in self._seen and r not in chosen:
                    cand.append(r)
                    if len(cand) >= self.pool:
                        break
            if not cand:                       # space exhausted
                out.append(comp.sample_row_rejection(rng))
                continue
            X = CompiledSpace.codes_for(self.space, np.asarray(cand))
            mu = self.model.predict(X)
            score = mu - self._slot_kappa(slot) * self._spread(X)
            pick = cand[int(np.argmin(score))]
            chosen.add(pick)
            out.append(pick)
        return out

    def tell_rows(self, rows, objectives) -> None:
        from ..spacetable import CompiledSpace
        codes = CompiledSpace.codes_for(self.space, np.asarray(rows)).tolist()
        for row, obj, enc in zip(rows, objectives, codes):
            row, obj = int(row), float(obj)
            if row in self._seen:
                continue
            self._seen.add(row)
            if not math.isfinite(obj):
                continue
            self.X.append(tuple(enc))
            self.y.append(math.log(max(obj, 1e-12)))
            self._since_fit += 1
            if self.model is None or self._since_fit >= self.refit_every:
                self._fit()

    # -- scalar path (oracle / fallback) ---------------------------------- #
    def _ask_batch_scalar(self, n: int) -> list[Config]:
        out: list[Config] = []
        chosen: set[int] = set()
        for slot in range(max(1, n)):
            if len(self.y) < self.n_init or self.model is None:
                out.append(self.space.sample(self.rng))
                continue
            # candidates not yet told — on small spaces re-asking the argmin
            # forever would stall behind the runner's dedup cache
            cands: list[Config] = []
            keys: list[int] = []
            for _ in range(self.pool * 4):
                c = self.space.sample(self.rng)
                k = self.space.flat_index(c)
                if k not in self._seen and k not in chosen:
                    cands.append(c)
                    keys.append(k)
                    if len(cands) >= self.pool:
                        break
            if not cands:                      # space exhausted
                out.append(self.space.sample(self.rng))
                continue
            X = np.array([self.space.encode(c) for c in cands], dtype=np.int64)
            mu = self.model.predict(X)
            score = mu - self._slot_kappa(slot) * self._spread(X)   # LCB
            pick = int(np.argmin(score))
            chosen.add(keys[pick])
            out.append(cands[pick])
        return out

    def ask_scalar(self) -> Config:
        return self._ask_batch_scalar(1)[0]

    def ask_batch(self, n: int) -> list[Config]:
        if self._warm_queue:           # warm rows first (base-class seam)
            return Tuner.ask_batch(self, n)
        if self.index_native:
            return self._comp.decode_many(self.ask_rows(max(1, n)))
        return self._ask_batch_scalar(n)

    def tell_scalar(self, trial: Trial) -> None:
        key = self.space.flat_index(trial.config)
        if key in self._seen:
            return
        self._seen.add(key)
        if not trial.ok:
            return
        self.X.append(self.space.encode(trial.config))
        self.y.append(math.log(max(trial.objective, 1e-12)))
        self._since_fit += 1
        if self.model is None or self._since_fit >= self.refit_every:
            self._fit()
