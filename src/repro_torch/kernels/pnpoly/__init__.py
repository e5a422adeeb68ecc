from .ops import pnpoly
from .space import PnpolyProblem

__all__ = ["pnpoly", "PnpolyProblem"]
