from .ops import attention
from .space import AttentionProblem

__all__ = ["attention", "AttentionProblem"]
