"""The port's tuner registry.  Later slices add the JAX package's other six."""

from .base import TuneResult, Tuner, run_many, run_tuner
from .genetic import GeneticAlgorithm
from .random_search import RandomSearch

TUNERS = {t.name: t for t in (RandomSearch, GeneticAlgorithm)}

__all__ = [
    "Tuner", "TuneResult", "run_tuner", "run_many", "TUNERS",
    "RandomSearch", "GeneticAlgorithm",
]
