"""The port's tuner registry.  Later slices add the JAX package's other five."""

from .base import TuneResult, Tuner, run_many, run_tuner
from .genetic import GeneticAlgorithm
from .grid_search import GridSearch
from .random_search import RandomSearch

TUNERS = {t.name: t for t in (RandomSearch, GridSearch, GeneticAlgorithm)}

__all__ = [
    "Tuner", "TuneResult", "run_tuner", "run_many", "TUNERS",
    "RandomSearch", "GridSearch", "GeneticAlgorithm",
]
