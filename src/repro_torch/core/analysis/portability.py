"""Fig 5: performance portability of optimal configurations across
architectures (paper: four GPUs; here: the Hopper cost model's arch ids
and the card's measured one).

transfer[i][j] = perf(opt_i on arch_j) / perf(opt_j on arch_j) — the relative
performance on arch_j when simply reusing arch_i's optimum.
"""

from __future__ import annotations

import math

import numpy as np

from ..results import ResultTable


def portability_matrix(tables: dict[str, ResultTable]) -> dict:
    """``tables``: arch -> exhaustive/sampled table over the SAME config set.

    Requires the config universe to overlap (exhaustive tables, or sampled
    tables generated with the same seed — the suite guarantees the latter).
    """
    archs = list(tables)
    # objective lookup per arch: encoded config -> seconds
    look: dict[str, dict[tuple, float]] = {}
    best_cfg: dict[str, tuple] = {}
    best_t: dict[str, float] = {}
    for a, tb in tables.items():
        d = {tuple(c): o for c, o in zip(tb.configs, tb.objectives)}
        look[a] = d
        fin = {c: o for c, o in d.items() if math.isfinite(o)}
        bc = min(fin, key=fin.get)
        best_cfg[a], best_t[a] = bc, fin[bc]

    n = len(archs)
    mat = np.full((n, n), np.nan)
    for i, ai in enumerate(archs):           # row: where the optimum came from
        for j, aj in enumerate(archs):       # col: where it is deployed
            t = look[aj].get(best_cfg[ai], math.inf)
            mat[i, j] = best_t[aj] / t if math.isfinite(t) else 0.0
    return {"archs": archs, "matrix": mat.tolist(),
            "best_config": {a: list(best_cfg[a]) for a in archs},
            "worst_transfer": float(np.nanmin(mat)),
            "best_off_diagonal": float(
                np.nanmax(mat[~np.eye(n, dtype=bool)])) if n > 1 else math.nan}
