"""The port's benchmark kernels, one package each (GEMM so far)."""

from .matmul import GemmProblem

__all__ = ["GemmProblem"]
