from .ops import nbody
from .space import NbodyProblem

__all__ = ["nbody", "NbodyProblem"]
