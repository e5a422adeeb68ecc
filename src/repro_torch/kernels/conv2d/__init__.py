from .ops import conv2d
from .space import Conv2dProblem

__all__ = ["conv2d", "Conv2dProblem"]
