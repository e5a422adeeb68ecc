from .ops import dedisp
from .space import DedispProblem

__all__ = ["dedisp", "DedispProblem"]
