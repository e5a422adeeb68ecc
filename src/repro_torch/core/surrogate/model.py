"""The per-kernel surrogate: a serializable GBDT over codes + arch ordinal.

Wraps :class:`repro_torch.core.mlmodel.GradientBoostedTrees` with the feature
schema from :mod:`.dataset`, adds ranking queries over a target
architecture's compiled space (``top_rows`` — the warm-start producer) and
cross-arch permutation importances (the PFI-consistency check), and
round-trips losslessly through JSON: trees serialize as flat preorder node
tables, so a loaded model predicts bit-identically to the fitted one.
"""

from __future__ import annotations

import math

import numpy as np

from ..mlmodel import (GradientBoostedTrees, RegressionTree, _TreeNode,
                       permutation_importance, r2_score)
from ..space import SearchSpace
from ..spacetable import CompiledSpace
from .dataset import TrainingSet

#: GBDT hyperparameters a surrogate records in its header (and therefore
#: part of the serialized-model identity)
DEFAULT_PARAMS = {
    "n_trees": 120, "learning_rate": 0.1, "max_depth": 6,
    "min_samples_leaf": 3, "subsample": 0.9, "seed": 0,
}

#: candidate-pool size when ranking a space too large to compile
_FALLBACK_POOL = 4096


# -- tree (de)serialization: flat preorder node tables ---------------------- #
def _tree_to_nodes(root: _TreeNode) -> list[list]:
    """Preorder flatten: ``[feature, threshold, value, left, right]`` per
    node, child fields are node-list indices (-1 for leaves)."""
    nodes: list[list] = []

    def walk(node: _TreeNode) -> int:
        i = len(nodes)
        nodes.append([int(node.feature), float(node.threshold),
                      float(node.value), -1, -1])
        if node.feature >= 0 and node.left is not None:
            nodes[i][3] = walk(node.left)
            nodes[i][4] = walk(node.right)
        return i

    walk(root)
    return nodes


def _tree_from_nodes(nodes: list[list]) -> _TreeNode:
    built = [None] * len(nodes)
    # children have larger indices in preorder, so build back-to-front
    for i in range(len(nodes) - 1, -1, -1):
        feature, threshold, value, left, right = nodes[i]
        node = _TreeNode(float(value))
        if int(feature) >= 0 and int(left) >= 0:
            node.feature = int(feature)
            node.threshold = float(threshold)
            node.left = built[int(left)]
            node.right = built[int(right)]
        built[i] = node
    return built[0]


class KernelSurrogate:
    """One kernel's cross-architecture performance model."""

    def __init__(self, problem: str, param_names: tuple[str, ...],
                 archs: tuple[str, ...], params: dict | None = None):
        self.problem = problem
        self.param_names = tuple(param_names)
        self.archs = tuple(archs)
        self.params = dict(DEFAULT_PARAMS, **(params or {}))
        self.model: GradientBoostedTrees | None = None
        self.n_rows = 0

    # -- training ----------------------------------------------------------- #
    @classmethod
    def fit(cls, ts: TrainingSet,
            params: dict | None = None) -> "KernelSurrogate":
        self = cls(ts.problem, ts.param_names, ts.archs, params)
        p = self.params
        self.model = GradientBoostedTrees(
            n_trees=int(p["n_trees"]), learning_rate=float(p["learning_rate"]),
            max_depth=int(p["max_depth"]),
            min_samples_leaf=int(p["min_samples_leaf"]),
            subsample=float(p["subsample"]), seed=int(p["seed"]),
        ).fit(ts.X, ts.y)
        self.n_rows = len(ts)
        return self

    # -- prediction --------------------------------------------------------- #
    @property
    def feature_names(self) -> tuple[str, ...]:
        return (*self.param_names, "arch")

    def arch_ordinal(self, arch: str) -> int:
        if arch not in self.archs:
            raise ValueError(f"arch {arch!r} not in model vocabulary "
                             f"{self.archs}")
        return self.archs.index(arch)

    def predict_log(self, X: np.ndarray) -> np.ndarray:
        """log-seconds predictions on a full feature matrix."""
        if self.model is None:
            raise ValueError("surrogate not fitted")
        return self.model.predict(np.asarray(X))

    def predict_rows(self, space: SearchSpace, rows, arch: str) -> np.ndarray:
        """Predicted *seconds* for flat rows on one architecture."""
        rows = np.asarray(rows, dtype=np.int64)
        codes = CompiledSpace.codes_for(space, rows)
        ordcol = np.full((len(rows), 1), self.arch_ordinal(arch),
                         dtype=np.int64)
        return np.exp(self.predict_log(np.concatenate([codes, ordcol],
                                                      axis=1)))

    def top_rows(self, space: SearchSpace, arch: str, k: int = 16,
                 pool_seed: int = 0) -> list[int]:
        """The ``k`` predicted-fastest valid rows of ``space`` on ``arch``
        (prediction-ascending — the warm-start queue).  Compiled spaces
        rank every valid row; uncompilable ones rank a seeded distinct
        sample so the result stays deterministic."""
        comp = space.compile_eagerly()
        if comp is not None:
            cand = comp.valid_rows
        else:
            cfgs = space.sample_distinct(_FALLBACK_POOL, seed=pool_seed)
            cand = np.asarray(sorted({space.flat_index(c) for c in cfgs}),
                              dtype=np.int64)
        if not len(cand):
            return []
        preds = self.predict_rows(space, cand, arch)
        order = np.argsort(preds, kind="stable")[:max(0, int(k))]
        return [int(cand[i]) for i in order]

    # -- evaluation --------------------------------------------------------- #
    def r2(self, ts: TrainingSet) -> float:
        return r2_score(ts.y, self.predict_log(ts.X))

    def importances(self, ts: TrainingSet, n_repeats: int = 3,
                    seed: int = 0) -> dict[str, float]:
        """Per-feature PFI on a (held-out) set, keyed by feature name."""
        pfi = permutation_importance(self.model, ts.X, ts.y,
                                     n_repeats=n_repeats, seed=seed)
        return dict(zip(self.feature_names, (float(v) for v in pfi)))

    def top_params(self, ts: TrainingSet, k: int = 3) -> list[str]:
        """The ``k`` most important *parameters* (arch column excluded) —
        the cross-arch consistency probe."""
        imp = self.importances(ts)
        imp.pop("arch", None)
        return sorted(imp, key=imp.get, reverse=True)[:k]

    # -- (de)serialization --------------------------------------------------- #
    def payload(self) -> dict:
        """The checksummed model section (header fields live in the store)."""
        if self.model is None:
            raise ValueError("surrogate not fitted")
        return {
            "base": self.model.base,
            "learning_rate": self.model.learning_rate,
            "trees": [_tree_to_nodes(t.root) for t in self.model.trees],
        }

    @classmethod
    def from_parts(cls, problem: str, param_names, archs, params: dict,
                   n_rows: int, payload: dict) -> "KernelSurrogate":
        self = cls(problem, tuple(param_names), tuple(archs), params)
        m = GradientBoostedTrees(
            n_trees=len(payload["trees"]),
            learning_rate=float(payload["learning_rate"]))
        m.base = float(payload["base"])
        m.trees = []
        for nodes in payload["trees"]:
            t = RegressionTree()
            t.root = _tree_from_nodes(nodes)
            m.trees.append(t)
        self.model = m
        self.n_rows = int(n_rows)
        if not math.isfinite(m.base):
            raise ValueError("non-finite model base")
        return self
