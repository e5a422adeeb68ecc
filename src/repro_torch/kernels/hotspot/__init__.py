from .ops import hotspot
from .space import HotspotProblem

__all__ = ["hotspot", "HotspotProblem"]
