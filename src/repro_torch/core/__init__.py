"""repro_torch.core — search spaces, the problem interface, tuners, results.

Copies of the JAX package's ``repro.core`` modules (imports rewritten, same
behaviour), except :mod:`.problem`, whose evaluators are the port's own.
"""

from .problem import (DEFAULT_ARCH, FunctionProblem, MeasuredProblem, Trial,
                      TunableProblem, materialize_configs)
from .results import ResultsDB, ResultTable
from .space import Config, Constraint, Param, SearchSpace, powers_of_two
from .spacetable import CompiledSpace

__all__ = [
    "SearchSpace", "Param", "Constraint", "Config", "powers_of_two",
    "CompiledSpace",
    "TunableProblem", "FunctionProblem", "MeasuredProblem", "Trial",
    "materialize_configs", "DEFAULT_ARCH",
    "ResultsDB", "ResultTable",
]
