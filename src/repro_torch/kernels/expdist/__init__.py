from .ops import expdist
from .space import ExpdistProblem

__all__ = ["expdist", "ExpdistProblem"]
