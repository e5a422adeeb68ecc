"""Fig 2: convergence towards the optimum under random search.

Protocol from the paper: draw random configs (without replacement) from the
recorded table, track best-so-far, repeat 100 times, report the median curve
of *relative performance* (t_best_table / t_best_so_far) vs evaluations.
"""

from __future__ import annotations

import numpy as np

from ..results import ResultTable


def random_search_curves(table: ResultTable, budget: int = 1000,
                         repeats: int = 100, seed: int = 0) -> np.ndarray:
    """(repeats, budget) best-so-far *relative performance* curves."""
    t = np.array(table.objectives)
    finite = np.isfinite(t)
    idx_pool = np.nonzero(finite)[0]
    t_best = t[idx_pool].min()
    rng = np.random.default_rng(seed)
    budget = min(budget, len(idx_pool))
    curves = np.empty((repeats, budget))
    for r in range(repeats):
        picks = rng.choice(idx_pool, size=budget, replace=False)
        best = np.minimum.accumulate(t[picks])
        curves[r] = t_best / best
    return curves


def median_curve(table: ResultTable, budget: int = 1000, repeats: int = 100,
                 seed: int = 0) -> np.ndarray:
    return np.median(random_search_curves(table, budget, repeats, seed), axis=0)


def evals_to_reach(curve: np.ndarray, level: float = 0.9) -> int:
    """First evaluation index (1-based) at which the curve reaches ``level``
    relative performance; -1 if never.  This is the paper's '90% after N
    evaluations' statistic (C2)."""
    hit = np.nonzero(curve >= level)[0]
    return int(hit[0]) + 1 if len(hit) else -1
