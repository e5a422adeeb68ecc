"""Landscape analyses — one module per paper figure/table (portability
comes with a second arch id)."""

from .centrality import (FFG, build_ffg, build_ffg_reference,
                         centrality_curve, pagerank,
                         proportion_of_centrality)
from .convergence import evals_to_reach, median_curve, random_search_curves
from .distribution import (distribution_profile, relative_performance,
                           speedup_over_median, top_cluster_fraction)
from .importance import (feature_importance, fit_surrogate, important_params,
                         reduced_space)
from .spacestats import reduced_stats, space_stats

__all__ = [
    "build_ffg", "build_ffg_reference", "pagerank",
    "proportion_of_centrality", "centrality_curve",
    "FFG", "median_curve", "random_search_curves", "evals_to_reach",
    "distribution_profile", "relative_performance", "speedup_over_median",
    "top_cluster_fraction", "feature_importance", "fit_surrogate",
    "important_params", "reduced_space", "space_stats", "reduced_stats",
]
