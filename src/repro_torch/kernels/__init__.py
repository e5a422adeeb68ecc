"""The port's benchmark kernels, one package each, and their registry."""

from .attention import AttentionProblem
from .conv2d import Conv2dProblem
from .dedisp import DedispProblem
from .expdist import ExpdistProblem
from .hotspot import HotspotProblem
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
    "hotspot_h100": HotspotProblem,
    "dedisp_h100": DedispProblem,
    "expdist_h100": ExpdistProblem,
    "flash_attention_h100": AttentionProblem,
}

#: the problems whose whole space the card measures in minutes (the paper's
#: exhaustive protocol, the JAX package's ``EXHAUSTIVE`` less GEMM, whose
#: 4992 configs at 4096^3 are tuned and sampled)
EXHAUSTIVE = ("pnpoly_h100", "nbody_h100", "conv2d_h100",
              "flash_attention_h100")
#: the paper's sampled spaces (its section V-A): ``SAMPLE_N`` distinct
#: random configs each, a space that admits no more measured whole
SAMPLED = ("hotspot_h100", "dedisp_h100", "expdist_h100")
SAMPLE_N = 10_000

__all__ = ["BENCHMARKS", "EXHAUSTIVE", "SAMPLED", "SAMPLE_N", "GemmProblem",
           "AttentionProblem", "NbodyProblem", "PnpolyProblem",
           "Conv2dProblem", "HotspotProblem", "DedispProblem",
           "ExpdistProblem"]
