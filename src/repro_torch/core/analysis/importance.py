"""Fig 6 + Table VIII reduction: surrogate fit + Permutation Feature Importance.

Protocol from the paper: train a boosted-tree regressor on (config -> perf),
report R², compute PFI per parameter, note that PFI sums ≫ 1 imply parameter
interactions (need for global optimization), and reduce the space to params
with PFI ≥ 0.05 on any architecture.
"""

from __future__ import annotations

import numpy as np

from ..mlmodel import GradientBoostedTrees, permutation_importance, r2_score
from ..results import ResultTable
from ..space import SearchSpace


def fit_surrogate(table: ResultTable, n_trees: int = 150, max_depth: int = 6,
                  seed: int = 0, max_rows: int | None = 20_000
                  ) -> tuple[GradientBoostedTrees, np.ndarray, np.ndarray]:
    """Fit GBDT on log-time over the finite rows; returns (model, X, y)."""
    rows = [(c, o) for c, o in zip(table.configs, table.objectives)
            if np.isfinite(o)]
    if max_rows is not None and len(rows) > max_rows:
        rng = np.random.default_rng(seed)
        take = rng.choice(len(rows), size=max_rows, replace=False)
        rows = [rows[i] for i in take]
    X = np.array([c for c, _ in rows], dtype=np.int64)
    y = np.log(np.array([o for _, o in rows]))
    model = GradientBoostedTrees(n_trees=n_trees, max_depth=max_depth,
                                 min_samples_leaf=3, seed=seed).fit(X, y)
    return model, X, y


def feature_importance(table: ResultTable, seed: int = 0,
                       n_repeats: int = 3) -> dict:
    """Returns per-parameter PFI, R², and the interaction indicator (sum)."""
    model, X, y = fit_surrogate(table, seed=seed)
    r2 = r2_score(y, model.predict(X))
    pfi = permutation_importance(model, X, y, n_repeats=n_repeats, seed=seed)
    return {
        "params": list(table.param_names),
        "pfi": pfi.tolist(),
        "r2": float(r2),
        "pfi_sum": float(pfi.sum()),     # ≫ 1 -> interactions (C6)
    }


def important_params(importances: dict[str, dict],
                     threshold: float = 0.05) -> list[str]:
    """Params with PFI ≥ threshold on ANY architecture (paper's reduction rule)."""
    keep: set[str] = set()
    names: list[str] = []
    for imp in importances.values():
        names = imp["params"]
        for name, v in zip(imp["params"], imp["pfi"]):
            if v >= threshold:
                keep.add(name)
    return [n for n in names if n in keep]


def reduced_space(space: SearchSpace, importances: dict[str, dict],
                  best_config: dict, threshold: float = 0.05) -> SearchSpace:
    """Table VIII 'Reduced': keep only important params, freeze the rest to
    the best-known configuration's values."""
    keep = important_params(importances, threshold)
    frozen = {k: v for k, v in best_config.items() if k not in keep}
    return space.reduce(keep, frozen=frozen, name=f"{space.name}-reduced")
