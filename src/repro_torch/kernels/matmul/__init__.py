from .ops import gemm
from .space import GemmProblem

__all__ = ["gemm", "GemmProblem"]
