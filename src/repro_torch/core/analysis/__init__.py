"""Landscape analyses.  The port has the distribution statistics so far."""

from .distribution import (distribution_profile, relative_performance,
                           speedup_over_median, top_cluster_fraction)

__all__ = ["distribution_profile", "relative_performance",
           "speedup_over_median", "top_cluster_fraction"]
