"""repro_torch.core — search spaces, the problem interface, the Hopper cost
model, eight tuners, results.

Copies of the JAX package's ``repro.core`` modules (imports rewritten, same
behaviour), except :mod:`.problem`, whose evaluators are the port's own, and
:mod:`.costmodel`, whose table is the Hopper cards' (``GPU_GENERATIONS``).
``DEFAULT_ARCH`` here is the measured card's id (``h100``); the cost
model's own default is ``costmodel.DEFAULT_ARCH`` (``h100sxm``).
"""

from .costmodel import (ARCH_NAMES, GPU_GENERATIONS, FeatureBatch,
                        KernelFeatures, estimate_seconds,
                        estimate_seconds_batch, estimate_seconds_many)
from .problem import (DEFAULT_ARCH, FunctionProblem, MeasuredProblem, Trial,
                      TunableProblem, materialize_configs)
from .results import ResultsDB, ResultTable
from .space import Config, Constraint, Param, SearchSpace, powers_of_two
from .spacetable import CompiledSpace, set_cache_dir

__all__ = [
    "SearchSpace", "Param", "Constraint", "Config", "powers_of_two",
    "CompiledSpace", "set_cache_dir",
    "TunableProblem", "FunctionProblem", "MeasuredProblem", "Trial",
    "materialize_configs", "DEFAULT_ARCH",
    "ResultsDB", "ResultTable",
    "KernelFeatures", "FeatureBatch", "estimate_seconds",
    "estimate_seconds_batch", "estimate_seconds_many",
    "GPU_GENERATIONS", "ARCH_NAMES",
]
