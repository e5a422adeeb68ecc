"""The port's benchmark kernels, one package each, their public ops and
their registry.  ``flash_attention`` is the port's public attention op
(``attention.ops.attention``)."""

from .attention import AttentionProblem, flash_attention
from .conv2d import Conv2dProblem, conv2d
from .dedisp import DedispProblem, dedisp
from .expdist import ExpdistProblem, expdist
from .hotspot import HotspotProblem, hotspot
from .matmul import GemmProblem, gemm
from .nbody import NbodyProblem, nbody
from .pnpoly import PnpolyProblem, pnpoly

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


def launch_counts() -> dict[str, int]:
    """Each public op's count of kernel launches (its wrapper's calls that
    launched the CUDA kernel; the plain version on the CPU counts none),
    by kernel name."""
    from .attention import ops as attention
    from .conv2d import ops as conv2d
    from .dedisp import ops as dedisp
    from .expdist import ops as expdist
    from .hotspot import ops as hotspot
    from .matmul import ops as matmul
    from .nbody import ops as nbody
    from .pnpoly import ops as pnpoly
    return {"gemm": matmul.gemm.launches,
            "flash_attention": attention.attention.launches,
            "nbody": nbody.nbody.launches, "pnpoly": pnpoly.pnpoly.launches,
            "conv2d": conv2d.conv2d.launches,
            "hotspot": hotspot.hotspot.launches,
            "expdist": expdist.expdist.launches,
            "dedisp": dedisp.dedisp.launches}


__all__ = ["BENCHMARKS", "EXHAUSTIVE", "SAMPLED", "SAMPLE_N", "launch_counts",
           "GemmProblem", "AttentionProblem", "NbodyProblem", "PnpolyProblem",
           "Conv2dProblem", "HotspotProblem", "DedispProblem",
           "ExpdistProblem",
           "gemm", "conv2d", "nbody", "hotspot", "pnpoly", "expdist",
           "dedisp", "flash_attention"]
