"""Histogram gradient-boosted regression trees + PFI, from scratch (numpy).

Stand-in for the paper's CatBoost regressor: configs are encoded as small
integer index vectors (each parameter's value index), which *are* histogram
bins — so an exact histogram GBDT is natural and fast.  Used by
(a) ``analysis/importance.py`` for Permutation Feature Importance (Fig 6) and
(b) the surrogate-model Bayesian-style tuner.
"""

from __future__ import annotations

import numpy as np


class _TreeNode:
    __slots__ = ("feature", "threshold", "left", "right", "value")

    def __init__(self, value: float):
        self.feature = -1
        self.threshold = 0.0
        self.left: "_TreeNode | None" = None
        self.right: "_TreeNode | None" = None
        self.value = value


class RegressionTree:
    """Exact histogram CART tree for integer-binned features."""

    def __init__(self, max_depth: int = 6, min_samples_leaf: int = 5,
                 min_gain: float = 1e-12):
        self.max_depth = max_depth
        self.min_samples_leaf = min_samples_leaf
        self.min_gain = min_gain
        self.root: _TreeNode | None = None

    def fit(self, X: np.ndarray, y: np.ndarray) -> "RegressionTree":
        X = np.asarray(X, dtype=np.int64)
        if X.ndim != 2:
            X = X.reshape(len(X), -1)
        y = np.asarray(y, dtype=np.float64)
        self.n_features = X.shape[1]
        self._nbins = X.max(axis=0) + 1 if len(X) else np.ones(X.shape[1], int)
        self.root = self._grow(X, y, depth=0)
        return self

    def _grow(self, X: np.ndarray, y: np.ndarray, depth: int) -> _TreeNode:
        node = _TreeNode(float(y.mean()) if len(y) else 0.0)
        n = len(y)
        # degenerate inputs produce the same split-less leaf the full scan
        # would (every candidate split has zero gain, or no candidate clears
        # min_samples_leaf) — return it before paying for the scan
        if n <= 1 or (n and (y == y[0]).all()):
            return node
        if depth >= self.max_depth or n < 2 * self.min_samples_leaf:
            return node
        total_sum, total_cnt = y.sum(), float(n)
        parent_score = total_sum * total_sum / total_cnt
        best = (self.min_gain, -1, -1)      # (gain, feature, threshold_bin)
        for f in range(X.shape[1]):
            nb = int(self._nbins[f])
            if nb < 2:
                continue
            col = X[:, f]
            cnt = np.bincount(col, minlength=nb).astype(np.float64)
            s = np.bincount(col, weights=y, minlength=nb)
            ccnt = np.cumsum(cnt)[:-1]          # left counts for thr=0..nb-2
            csum = np.cumsum(s)[:-1]
            rcnt = total_cnt - ccnt
            rsum = total_sum - csum
            okmask = (ccnt >= self.min_samples_leaf) & (rcnt >= self.min_samples_leaf)
            if not okmask.any():
                continue
            with np.errstate(divide="ignore", invalid="ignore"):
                score = np.where(okmask,
                                 csum * csum / np.maximum(ccnt, 1)
                                 + rsum * rsum / np.maximum(rcnt, 1), -np.inf)
            t = int(np.argmax(score))
            gain = float(score[t]) - parent_score
            if gain > best[0]:
                best = (gain, f, t)
        if best[1] < 0:
            return node
        _, f, t = best
        mask = X[:, f] <= t
        node.feature, node.threshold = f, float(t) + 0.5
        node.left = self._grow(X[mask], y[mask], depth + 1)
        node.right = self._grow(X[~mask], y[~mask], depth + 1)
        return node

    def predict(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X, dtype=np.float64)
        out = np.empty(len(X), dtype=np.float64)
        # iterative batch traversal
        idx = np.arange(len(X))
        stack = [(self.root, idx)]
        while stack:
            node, ix = stack.pop()
            if node.feature < 0 or node.left is None:
                out[ix] = node.value
                continue
            mask = X[ix, node.feature] <= node.threshold
            stack.append((node.left, ix[mask]))
            stack.append((node.right, ix[~mask]))
        return out


class GradientBoostedTrees:
    """Squared-loss gradient boosting on histogram trees."""

    def __init__(self, n_trees: int = 150, learning_rate: float = 0.1,
                 max_depth: int = 6, min_samples_leaf: int = 5,
                 subsample: float = 1.0, seed: int = 0):
        self.n_trees = n_trees
        self.learning_rate = learning_rate
        self.max_depth = max_depth
        self.min_samples_leaf = min_samples_leaf
        self.subsample = subsample
        self.seed = seed
        self.trees: list[RegressionTree] = []
        self.base = 0.0

    def fit(self, X: np.ndarray, y: np.ndarray) -> "GradientBoostedTrees":
        X = np.asarray(X, dtype=np.int64)
        y = np.asarray(y, dtype=np.float64)
        rng = np.random.default_rng(self.seed)
        self.base = float(y.mean()) if len(y) else 0.0
        pred = np.full(len(y), self.base)
        self.trees = []
        if not len(y):                 # nothing to boost on
            return self
        for _ in range(self.n_trees):
            resid = y - pred
            if self.subsample < 1.0:
                take = rng.random(len(y)) < self.subsample
                if take.sum() < 2 * self.min_samples_leaf:
                    take[:] = True
            else:
                take = slice(None)
            tree = RegressionTree(self.max_depth, self.min_samples_leaf)
            tree.fit(X[take], resid[take])
            self.trees.append(tree)
            pred += self.learning_rate * tree.predict(X)
        return self

    def predict(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X, dtype=np.float64)
        out = np.full(len(X), self.base)
        for tree in self.trees:
            out += self.learning_rate * tree.predict(X)
        return out


def r2_score(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    y_true = np.asarray(y_true, dtype=np.float64)
    y_pred = np.asarray(y_pred, dtype=np.float64)
    ss_res = float(((y_true - y_pred) ** 2).sum())
    ss_tot = float(((y_true - y_true.mean()) ** 2).sum())
    return 1.0 - ss_res / ss_tot if ss_tot > 0 else 0.0


def permutation_importance(model, X: np.ndarray, y: np.ndarray,
                           n_repeats: int = 3, seed: int = 0) -> np.ndarray:
    """PFI: drop in R² when one feature column is shuffled (mean of repeats)."""
    X = np.asarray(X)
    y = np.asarray(y, dtype=np.float64)
    rng = np.random.default_rng(seed)
    base = r2_score(y, model.predict(X))
    out = np.zeros(X.shape[1])
    for f in range(X.shape[1]):
        drops = []
        for _ in range(n_repeats):
            Xp = X.copy()
            Xp[:, f] = rng.permutation(Xp[:, f])
            drops.append(base - r2_score(y, model.predict(Xp)))
        out[f] = float(np.mean(drops))
    return out
