"""The port's benchmark kernels, one package each, and their registry."""

from .attention import AttentionProblem
from .conv2d import Conv2dProblem
from .matmul import GemmProblem
from .nbody import NbodyProblem
from .pnpoly import PnpolyProblem

#: the benchmark registry (problem name -> problem class); order follows
#: the JAX package's
BENCHMARKS = {
    "gemm_h100": GemmProblem,
    "nbody_h100": NbodyProblem,
    "pnpoly_h100": PnpolyProblem,
    "conv2d_h100": Conv2dProblem,
    "flash_attention_h100": AttentionProblem,
}

#: the problems whose whole space the card measures in minutes (the paper's
#: exhaustive protocol, the JAX package's ``EXHAUSTIVE`` less GEMM, whose
#: 1792 configs at 4096^3 are tuned and sampled); the rest are tuned and
#: sampled
EXHAUSTIVE = ("pnpoly_h100", "nbody_h100", "conv2d_h100",
              "flash_attention_h100")

__all__ = ["BENCHMARKS", "EXHAUSTIVE", "GemmProblem", "AttentionProblem",
           "NbodyProblem", "PnpolyProblem", "Conv2dProblem"]
