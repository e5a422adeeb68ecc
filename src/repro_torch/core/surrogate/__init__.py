"""Cross-session performance surrogate: transfer-aware warm starts.

The paper's PFI analysis (Fig 6) shows parameter *importance* is stable
across architectures while optimal *values* are not, and the portability
matrix shows naive config transfer is unreliable — so historical tuning
data from one architecture should inform, not seed verbatim, the search on
another.  This package closes that loop over the repo's own journals:

* :mod:`dataset` harvests training rows from journaled sessions and
  ResultsDB tables (features: per-parameter value-index codes + an arch
  ordinal column; target: log seconds),
* :mod:`model` fits the from-scratch histogram GBDT
  (:mod:`repro_torch.core.mlmodel`) on them and ranks a target architecture's
  compiled space,
* :mod:`store` persists per-kernel models with servedb-style durability
  (versioned header, sha256 section checksum, quarantine-on-corrupt),
* :mod:`screen` turns a model into a measurement screen for the tuner
  seams in :mod:`repro_torch.core.tuners.base` (warm start + screening).
"""

from .dataset import Harvest, TrainingSet
from .model import KernelSurrogate
from .screen import ESTIMATED_INFO, SurrogateScreen
from .store import HEADER_FIELDS, ModelStore, ModelStoreError

__all__ = [
    "Harvest", "TrainingSet", "KernelSurrogate",
    "SurrogateScreen", "ESTIMATED_INFO",
    "ModelStore", "ModelStoreError", "HEADER_FIELDS",
]
