"""The port's benchmark kernels, one package each, and their registry."""

from .attention import AttentionProblem
from .matmul import GemmProblem

#: the benchmark registry (problem name -> problem class)
BENCHMARKS = {
    "gemm_h100": GemmProblem,
    "flash_attention_h100": AttentionProblem,
}

#: the problems whose whole space the card measures in minutes (the paper's
#: exhaustive protocol); the rest are tuned and sampled
EXHAUSTIVE = ("flash_attention_h100",)

__all__ = ["BENCHMARKS", "EXHAUSTIVE", "GemmProblem", "AttentionProblem"]
