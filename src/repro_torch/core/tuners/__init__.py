"""The port's tuner registry — every optimizer behind one interface."""

from .base import TuneResult, Tuner, run_many, run_tuner
from .random_search import RandomSearch
from .grid_search import GridSearch
from .local_search import LocalSearch
from .annealing import SimulatedAnnealing
from .genetic import GeneticAlgorithm
from .diffevo import DifferentialEvolution
from .pso import ParticleSwarm
from .surrogate_bo import SurrogateBO

TUNERS = {
    t.name: t for t in (
        RandomSearch, GridSearch, LocalSearch, SimulatedAnnealing,
        GeneticAlgorithm, DifferentialEvolution, ParticleSwarm, SurrogateBO)
}

__all__ = [
    "Tuner", "TuneResult", "run_tuner", "run_many", "TUNERS",
    "RandomSearch", "GridSearch", "LocalSearch", "SimulatedAnnealing",
    "GeneticAlgorithm", "DifferentialEvolution", "ParticleSwarm", "SurrogateBO",
]
