"""Fig 1 + Fig 4: performance-distribution shape and speedup over median.

The paper plots, per benchmark × architecture, the distribution of *relative
performance* centered on the median configuration, and reports the max
speedup of the best configuration over the median one.
"""

from __future__ import annotations

import math

import numpy as np

from ..results import ResultTable


def relative_performance(table: ResultTable) -> np.ndarray:
    """Per-config performance relative to the best (1.0 == optimal).

    Performance = 1/time, so rel-perf = t_best / t.  Invalid configs are
    dropped (they are the 'did not compile' analogue).
    """
    t = np.array(table.finite())
    if len(t) == 0:
        return np.array([])
    return t.min() / t


def distribution_profile(table: ResultTable,
                         quantiles: np.ndarray | None = None) -> dict:
    """Quantile profile of rel-perf, normalized to the median config —
    the data behind Fig 1's density curves."""
    rel = relative_performance(table)
    if quantiles is None:
        quantiles = np.linspace(0.0, 1.0, 101)
    q = np.quantile(rel, quantiles)
    med = float(np.median(rel))
    return {
        "quantiles": quantiles.tolist(),
        "rel_perf": q.tolist(),
        "rel_to_median": (q / med).tolist(),
        "median": med,
        "n": int(len(rel)),
    }


def speedup_over_median(table: ResultTable) -> float:
    """Fig 4: t_median / t_best."""
    t = np.array(table.finite())
    if len(t) == 0:
        return math.nan
    return float(np.median(t) / t.min())


def top_cluster_fraction(table: ResultTable, within: float = 0.10) -> float:
    """Fraction of configs within ``within`` of optimal performance —
    quantifies the 'Hotspot high-performing cluster' observation (C1)."""
    rel = relative_performance(table)
    if len(rel) == 0:
        return math.nan
    return float((rel >= 1.0 - within).mean())
